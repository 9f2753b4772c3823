"""The torch port's SRHT design operator (ops/transforms.py) against the
JAX package's: bit-identical designs from one seed, and the same products
on the same numpy inputs.

Products are compared at rtol 1e-5 / atol 1e-4: the FWHT chains of the two
packages sum the same float32 terms in different orders, and entries that
cancel towards 0 carry an absolute error of a few 1e-6 times sqrt(w).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ldpc_sparc_tpu.config import SparcParams as JParams
from ldpc_sparc_tpu.ops import transforms as jtr
from ldpc_sparc_tpu_torch.config import SparcParams as TParams
from ldpc_sparc_tpu_torch.config import create_base_matrix
from ldpc_sparc_tpu_torch.ops import transforms as ttr
from ldpc_sparc_tpu_torch.parity import design_from_jax_leaves

# name -> (SparcParams kwargs, awgn_var)
CODES = {
    "plain": (dict(P=15.0, R=1.0, L=32, M=128), 1.0),
    "offset1": (dict(P=15.0, R=1.3, L=48, M=16), 1.0),   # w=1024, LM=768
    "pa": (dict(P=15.0, R=1.0, L=64, M=16, power_allocated=True, B=4,
                R_PA_ratio=1.0), 1.0),
    "sc": (dict(P=15.0, R=1.0, L=64, M=16, spatially_coupled=True, omega=2,
                Lambda=4), 1.0),
    # n = 512 rows of one row block over 4 column blocks of 256: tall, every
    # block summed into the one row block
    "pa_tall": (dict(P=15.0, R=0.5, L=64, M=16, power_allocated=True, B=4,
                     R_PA_ratio=1.0), 1.0),
}


def _designs(name, seed=5):
    kw, var = CODES[name]
    jd = jtr.SparcDesign.for_params(JParams(**kw), var, seed)
    td = ttr.SparcDesign.for_params(TParams(**kw), var, seed, device="cpu")
    return jd, td


@pytest.mark.parametrize("name", sorted(CODES))
def test_design_leaves_bit_identical(name):
    jd, td = _designs(name)
    np.testing.assert_array_equal(td.idx.numpy(), np.asarray(jd.idx))
    np.testing.assert_array_equal(td.signs.numpy(), np.asarray(jd.signs))
    np.testing.assert_array_equal(td.scale.numpy(), np.asarray(jd.scale))
    _, aux = jd.tree_flatten()
    assert (td.rows, td.cols, td.Lr, td.Lc, td.Mr, td.Mc, td.w, td.n, td.LM,
            td.offset) == aux


def test_offset1_design_shape():
    _, td = _designs("offset1")
    assert (td.w, td.offset, td.LM) == (1024, 1, 768)


@pytest.mark.parametrize("name", sorted(CODES))
def test_block_randomness_bit_identical(name):
    kw, var = CODES[name]
    W = create_base_matrix(TParams(**kw), var)
    jd, _ = _designs(name)
    for got, want in zip(
            ttr.generate_block_randomness(W, jd.Mr, jd.Mc, jd.w, (7, 1), jd.offset),
            jtr.generate_block_randomness(W, jd.Mr, jd.Mc, jd.w, (7, 1), jd.offset)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["plain", "sc"])
def test_design_from_jax_leaves_roundtrip(name):
    jd, td = _designs(name)
    leaves, aux = jd.tree_flatten()
    cd = design_from_jax_leaves(leaves, aux)
    for f in ("idx", "signs", "scale"):
        assert torch.equal(getattr(cd, f), getattr(td, f))
    assert cd.idx.dtype == torch.int64
    assert (cd.rows, cd.cols, cd.w, cd.n, cd.LM, cd.offset) == \
        (td.rows, td.cols, td.w, td.n, td.LM, td.offset)


@pytest.mark.parametrize("name", ["plain", "offset1", "sc"])
def test_products_match_jax(name):
    """ab and az on the same inputs and the same (carried) design; the SC
    design has E > 1 blocks and sums them with index_add_."""
    jd, _ = _designs(name)
    td = design_from_jax_leaves(*jd.tree_flatten())
    rng = np.random.default_rng(1)
    beta = rng.normal(size=jd.LM).astype(np.float32)
    z = rng.normal(size=jd.n).astype(np.float32)
    np.testing.assert_allclose(td.ab(torch.as_tensor(beta)).numpy(),
                               np.asarray(jd.ab(jnp.asarray(beta))),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(td.az(torch.as_tensor(z)).numpy(),
                               np.asarray(jd.az(jnp.asarray(z))),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("name", sorted(CODES))
def test_adjoint_identity(name):
    """<A x, y> = <x, A^T y> to float32 accumulation accuracy."""
    _, td = _designs(name)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal(td.LM).astype(np.float32))
    y = torch.as_tensor(rng.standard_normal(td.n).astype(np.float32))
    lhs = float(torch.dot(td.ab(x).double(), y.double()))
    rhs = float(torch.dot(x.double(), td.az(y).double()))
    np.testing.assert_allclose(lhs, rhs, rtol=2e-3)


def test_dense_matches_jax():
    """The materialised A of a 2x2-block design with a zero block."""
    W = np.array([[2.0, 0.0], [1.0, 3.0]])
    jd = jtr.SparcDesign.build(W, 8, 4, 8, seed=7)
    td = ttr.SparcDesign.build(W, 8, 4, 8, seed=7, device="cpu")
    np.testing.assert_allclose(td.dense(), jd.dense(), rtol=1e-6, atol=1e-6)


def test_batched_products_equal_single_calls():
    _, td = _designs("sc")
    rng = np.random.default_rng(3)
    xs = torch.as_tensor(rng.standard_normal((3, td.LM)).astype(np.float32))
    zs = torch.as_tensor(rng.standard_normal((2, 2, td.n)).astype(np.float32))
    torch.testing.assert_close(td.ab(xs), torch.stack([td.ab(x) for x in xs]),
                               rtol=1e-6, atol=1e-5)
    got = td.az(zs)
    assert got.shape == (2, 2, td.LM)
    torch.testing.assert_close(got[1, 0], td.az(zs[1, 0]), rtol=1e-6, atol=1e-5)


def test_plain_chain_option_is_the_same_on_cpu():
    """On CPU tensors the kernel route and fwht_kernel=False both run the
    plain chain."""
    _, td = _designs("plain")
    x = torch.randn(2, td.LM, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(td.ab(x), td.ab(x, fwht_kernel=False),
                               rtol=0, atol=0)



# ---- offset-0 products through K1's fused entry points -------------------------

@pytest.mark.parametrize("E,B", [(1, 1), (1, 3), (4, 2)])
@pytest.mark.parametrize("idx_side_is_input", [True, False])
def test_srht_apply_offset0_matches_jax(E, B, idx_side_is_input):
    """The port's srht_apply (which takes srht_scatter_fwht / srht_fwht_gather
    on a full offset-0 window) against the JAX srht_apply on the same numpy
    inputs, with a block scale, for one block and several and a batch of
    rows: within 1e-5 of the largest entry (float32 in both; torch's matmul
    precision is "highest" by default on the CPU)."""
    w, k = 256, 37
    rng = np.random.default_rng(E * 10 + B)
    idx = np.stack([np.sort(rng.choice(w, k, replace=False)) for _ in range(E)])
    signs = (rng.integers(0, 2, (E, w)) * 2 - 1).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, E).astype(np.float32)
    in_dim, out_dim = (k, w) if idx_side_is_input else (w, k)
    vals = rng.normal(size=(B, E, in_dim)).astype(np.float32)
    want = np.stack([np.asarray(jtr.srht_apply(
        jnp.asarray(vals[b]), jnp.asarray(idx.astype(np.int32)), jnp.asarray(signs),
        w, in_dim, out_dim, idx_side_is_input, offset=0, scale=jnp.asarray(scale)))
        for b in range(B)])
    ti = torch.as_tensor(idx)
    for idx32 in (None, ti.to(torch.int32)):
        got = ttr.srht_apply(torch.as_tensor(vals), ti, torch.as_tensor(signs), w,
                             in_dim, out_dim, idx_side_is_input, offset=0,
                             scale=torch.as_tensor(scale), idx32=idx32)
        assert got.shape == (B, E, out_dim)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
        plain = ttr.srht_apply(torch.as_tensor(vals), ti, torch.as_tensor(signs), w,
                               in_dim, out_dim, idx_side_is_input, offset=0,
                               scale=torch.as_tensor(scale), fwht_kernel=False)
        assert torch.equal(got, plain)


def test_design_checks_and_copies_its_index_set():
    _, td = _designs("sc")
    assert td._idx32.dtype == torch.int32 and torch.equal(td._idx32.long(), td.idx)
    bad = td.idx.clone()
    bad[0, -1] = td.w
    with pytest.raises(ValueError, match="outside"):
        ttr.SparcDesign(bad, td.signs, td.scale, td.rows, td.cols, td.Lr, td.Lc,
                        td.Mr, td.Mc, td.w, td.n, td.LM, td.offset)


def test_entry_points_take_the_card_by_default():
    """device=None resolves to the CUDA device or raises; the tests ask for
    the CPU by name."""
    from ldpc_sparc_tpu_torch.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    kw, var = CODES["plain"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.SparcDesign.for_params(TParams(**kw), var, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.SparcDesign.build(np.ones((1, 1)), 8, 4, 8, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.stack_designs(TParams(**kw), var, 0, 2)


# ---- the column segment table and the block-indexed route ----------------------

def _segments(seg, num):
    """Segment s's blocks, ascending, from the block coordinates."""
    return [[e for e, v in enumerate(seg) if v == s] for s in range(num)]


def _table_segments(ptr, blocks):
    p, b = ptr.tolist(), blocks.tolist()
    return [b[p[s]:p[s + 1]] for s in range(len(p) - 1)]


@pytest.mark.parametrize("name", sorted(CODES))
def test_column_segment_table_matches_cols(name):
    """The column table against the block coordinates; None where the
    design is tall (the tall PA design) or its columns are the identity (the
    plain, offset-1 and wide PA designs)."""
    _, td = _designs(name)
    if td.tall or td.cols == tuple(range(td.Lc)):
        assert td._col_ptr is None and td._col_blocks is None
        return
    assert td._col_ptr.dtype == td._col_blocks.dtype == torch.int32
    assert td._col_ptr.shape == (td.Lc + 1,) and td._col_blocks.shape == (td.E,)
    assert _table_segments(td._col_ptr, td._col_blocks) == _segments(td.cols, td.Lc)


@pytest.mark.parametrize("sec", [2, 4])
def test_segment_table_of_a_shard(sec):
    """A section shard made by `with_leaves` rebuilds its table from its own
    local cols (its blocks in column-major order)."""
    from ldpc_sparc_tpu_torch.parallel.sharded import ShardedDesign
    kw, var = CODES["sc"]
    sd = ShardedDesign(TParams(**kw), var, 5, device="cpu")
    for i in range(sec):
        loc = sd.shard(i, sec)
        assert loc.Lc == sd.Lc // sec and not loc.tall
        assert _table_segments(loc._col_ptr, loc._col_blocks) == \
            _segments(loc.cols, loc.Lc)


def test_segment_table_rejects_ids_outside():
    ptr, blocks = ttr.segment_table((0, 2, 2, 1), 3)
    assert ptr.tolist() == [0, 1, 2, 4] and blocks.tolist() == [0, 3, 1, 2]
    with pytest.raises(ValueError, match="outside"):
        ttr.segment_table((0, 3), 3)


ROUTE_YES = dict(device_type="cuda", fwht_kernel=True, fwht_mode="ms",
                 is_complex=False, offset=0, window=1 << 15, w=1 << 15,
                 tall=False, identity=False)
ROUTE_NO = {
    "cpu": dict(device_type="cpu"),
    "plain_chain": dict(fwht_kernel=False),
    "2mm": dict(fwht_mode="2mm"),
    "2mm_f32": dict(fwht_mode="2mm_f32"),
    "complex": dict(is_complex=True),
    "offset1": dict(offset=1, window=(1 << 15) - 1),
    "cluster_2_16": dict(window=1 << 16, w=1 << 16),
    "tall": dict(tall=True),
    "identity": dict(identity=True),
}


@pytest.mark.parametrize("w", [1, 1 << 12, 1 << 15])
def test_window_block_route_takes_the_block_route(w):
    assert ttr.window_block_route(**{**ROUTE_YES, "window": w, "w": w})


@pytest.mark.parametrize("case", sorted(ROUTE_NO))
def test_window_block_route_keeps_todays_route(case):
    """One condition off is enough to keep the select, srht_apply and
    index_add_ route."""
    assert not ttr.window_block_route(**{**ROUTE_YES, **ROUTE_NO[case]})


def _values_on(device_type, is_complex=False):
    """A stand-in for a tensor on `device_type`: the route reads only the
    device and whether the values are complex, so no card is needed."""
    import types
    return types.SimpleNamespace(device=torch.device(device_type),
                                 is_complex=lambda: is_complex)


# name -> whether the design's products take the block-indexed route on a card
DESIGN_ROUTES = {"plain": False, "offset1": False, "pa": False, "sc": True,
                 "pa_tall": False}


@pytest.mark.parametrize("name", sorted(DESIGN_ROUTES))
def test_design_routes_by_its_shape(name):
    """SC (several blocks a column) takes the route on a card; a one-block
    design, an offset-1 window, a PA design whose columns are the identity
    and a tall PA design (every block on the one row block) do not; neither
    does any design on the CPU, with complex values or in another mode."""
    _, td = _designs(name)
    assert td._block_route(_values_on("cuda"), True, "ms") == DESIGN_ROUTES[name]
    assert not td._block_route(_values_on("cpu"), True, "ms")
    assert not td._block_route(_values_on("cuda", True), True, "ms")
    assert not td._block_route(_values_on("cuda"), True, "2mm")
    assert not td._block_route(_values_on("cuda"), False, "ms")


def _sc_or_shard(name):
    """The SC design, or a section shard of it made by `with_leaves`."""
    if name == "sc":
        return _designs(name)[1]
    from ldpc_sparc_tpu_torch.parallel.sharded import ShardedDesign
    kw, var = CODES["sc"]
    return ShardedDesign(TParams(**kw), var, 5, device="cpu").shard(1, 2)


@pytest.mark.parametrize("name", ["sc", "sc_shard"])
def test_block_indexed_plain_versions_equal_select_and_sum(name):
    """The plain versions of the block-indexed products against the route
    they replace (select, per-block product, segment sum), on the column
    side of each product: ab's select, az's sum; bit for bit on the CPU,
    where index_add_ adds in block order."""
    from ldpc_sparc_tpu_torch.ops import wht_cuda
    td = _sc_or_shard(name)
    gen = torch.Generator().manual_seed(4)
    beta = torch.randn(3, td.LM, generator=gen)
    z = torch.randn(3, td.n, generator=gen)
    table = (td._col_ptr, td._col_blocks)
    xb, zb = beta.reshape(3, td.Lc, td.Mc), z.reshape(3, td.Lr, td.Mr)
    want_gather = td._fwd_blocks(td._select(xb, td.cols, td._cols_t, td.Lc))
    got = wht_cuda.srht_fwht_gather_blocks(xb.contiguous(), td.signs,
                                           td._idx32, *table) * td.scale[:, None]
    assert torch.equal(got, want_gather)
    x = td._select(zb, td.rows, td._rows_t, td.Lr) * td.scale[:, None]
    got = wht_cuda.srht_scatter_fwht_sum(x, td._idx32, td.signs, td.w, *table)
    assert torch.equal(got, td.az(z).reshape(3, td.Lc, td.Mc))


def test_block_indexed_products_reject_bad_tables():
    from ldpc_sparc_tpu_torch.ops import wht_cuda
    _, td = _designs("sc")
    x = torch.zeros(2, td.Lc, td.Mc)
    vals = torch.zeros(2, td.E, td.Mr)
    bad = td._col_blocks.clone()
    bad[0] = bad[1]   # not a permutation of the blocks
    with pytest.raises(ValueError, match="segment table"):
        wht_cuda.srht_fwht_gather_blocks(x, td.signs, td._idx32, td._col_ptr, bad)
    with pytest.raises(ValueError, match="segment table"):
        wht_cuda.srht_scatter_fwht_sum(vals, td._idx32, td.signs, td.w,
                                       td._col_ptr.flip(0), td._col_blocks)
    with pytest.raises(ValueError, match="int32"):
        wht_cuda.srht_fwht_gather_blocks(x, td.signs, td._idx32,
                                         td._col_ptr.long(), td._col_blocks)
    with pytest.raises(ValueError, match="widths up to"):
        wht_cuda.srht_scatter_fwht_sum(vals, td._idx32, None, 1 << 16,
                                       td._col_ptr, td._col_blocks)
