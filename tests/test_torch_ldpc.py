"""The port's LDPC path (tables, Tanner graph, code library, BP) against the
JAX package, on the same numpy inputs.

Host-side builders (protograph tables, `TannerGraph`, vdeg/cdeg/intrlv,
`pcmat`, the parity generator, `param_calc`) are numpy copies and must be
identical. Encoding is exact integer arithmetic and must be bit-identical.
The decoders run in float32 and sum a variable's messages in different
orders (the JAX package: the edges, then ch; the port: ch, then the edges
in ascending id), so iteration counts and hard decisions must be equal
and the APP LLRs agree to rtol 1e-5 / atol 1e-4, the bound the JAX package
holds its own Pallas and XLA decoders to (tests/test_bp_pallas.py). Against
the float64 C++ oracle, iteration counts and decisions must be equal.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ldpc_sparc_tpu import config as jcfg
from ldpc_sparc_tpu.models import ldpc as jldpc
from ldpc_sparc_tpu.models import ldpc_tables as jtables
from ldpc_sparc_tpu.native import oracle
from ldpc_sparc_tpu.ops import bp as jbp
from ldpc_sparc_tpu.ops.bp_pallas import bp_decode_pallas
from ldpc_sparc_tpu_torch import config as tcfg
from ldpc_sparc_tpu_torch.models import ldpc as tldpc
from ldpc_sparc_tpu_torch.models import ldpc_tables as ttables
from ldpc_sparc_tpu_torch.ops import bp as tbp
from ldpc_sparc_tpu_torch.ops import bp_cuda
from ldpc_sparc_tpu_torch.utils.tracing import counters


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs files in parallel processes: torch's intra-op thread
    pool in each of them oversubscribes the cores and slows these small
    tensors by 10x, so this file's torch work runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_16 = [("1/2", "A"), ("2/3", "A"), ("2/3", "B"), ("3/4", "A"), ("3/4", "B"),
       ("5/6", "A")]
# the 36 configurations of tests/test_ldpc.py
ALL_CONFIGS = ([("802.16", r, z, p) for z in (3, 27, 54, 81) for r, p in _16]
               + [("802.11n", r, z, "A") for z in (27, 54, 81)
                  for r in ("1/2", "2/3", "3/4", "5/6")])
GRAPH_CONFIGS = ALL_CONFIGS + [("802.16", "1/2", 6, "A"),
                               ("802.16", "1/2", 150, "A")]
APP_TOL = dict(rtol=1e-5, atol=1e-4)


def _codes(standard, rate, z, ptype="A"):
    return (jldpc.get_code(standard, rate, z, ptype),
            tldpc.get_code(standard, rate, z, ptype))


def _noisy_llrs(code, snr_db, n, seed):
    """(codewords, float32 LLRs) of n random codewords at snr_db, numpy."""
    rng = np.random.default_rng(seed)
    us = rng.integers(0, 2, (n, code.K))
    xs = code.parity_chain(us)
    xs = np.concatenate([us, xs], axis=1)
    sigma2 = 1.0 / 10 ** (snr_db / 10)
    ys = (1.0 - 2.0 * xs) + rng.normal(0, np.sqrt(sigma2), xs.shape)
    return xs, (2.0 / sigma2 * ys).astype(np.float32)


def test_protograph_tables_identical():
    assert ttables._TABLES == jtables._TABLES


@pytest.mark.parametrize("standard,rate,z,ptype", GRAPH_CONFIGS)
def test_graph_code_and_noiseless_decode(standard, rate, z, ptype):
    """Protograph, every TannerGraph field (in order, with its dtype), the
    flat graph, pcmat and the generator are identical; the port's encoder
    gives zero syndromes; a noiseless decode is a fixed point (0 iterations,
    exact recovery) for sumprod2 and minsum."""
    jc, tc = _codes(standard, rate, z, ptype)
    np.testing.assert_array_equal(tc.proto, jc.proto)
    jf = [f.name for f in dataclasses.fields(jbp.TannerGraph)]
    assert [f.name for f in dataclasses.fields(tbp.TannerGraph)] == jf
    for name in jf:
        a, b = getattr(tc.graph, name), getattr(jc.graph, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert type(a) is type(b) and a == b, name
    for name in ("vdeg", "cdeg", "intrlv"):
        a, b = getattr(tc, name), getattr(jc, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (tc.N, tc.K, tc.Nv, tc.Nc, tc.Nmsg) == (jc.N, jc.K, jc.Nv, jc.Nc,
                                                   jc.Nmsg)
    H = tc.pcmat()
    np.testing.assert_array_equal(H, jc.pcmat())
    np.testing.assert_array_equal(
        tc._Gp, np.asarray(jc._Gp.astype(jnp.float32)))

    rng = np.random.default_rng(GRAPH_CONFIGS.index((standard, rate, z, ptype)))
    us = rng.integers(0, 2, (12, tc.K))
    xs = tc.encode(torch.as_tensor(us)).numpy()
    assert np.count_nonzero((xs @ H.T) % 2) == 0
    ys = torch.as_tensor(10.0 * (0.5 - xs), dtype=torch.float32)
    for method in ("sumprod2", "minsum"):
        res = tc.decode(ys, 200, method)
        assert res.iterations.dtype == torch.int32
        assert bool((res.iterations == 0).all()), method
        np.testing.assert_array_equal(res.app.numpy() < 0, xs.astype(bool))


@pytest.mark.parametrize("standard,rate,z,ptype", [
    ("802.11n", "1/2", 27, "A"), ("802.16", "5/6", 54, "A"),
    ("802.16", "2/3", 81, "B"), ("802.16", "1/2", 150, "A"),
])
def test_encode_bit_identical(standard, rate, z, ptype):
    jc, tc = _codes(standard, rate, z, ptype)
    us = np.random.default_rng(7).integers(0, 2, (32, tc.K))
    xs = tc.encode(torch.as_tensor(us))
    assert xs.dtype == torch.int32
    xs = xs.numpy()
    np.testing.assert_array_equal(xs, np.asarray(jc.encode(jnp.asarray(us))))
    np.testing.assert_array_equal(xs[:, tc.K:], jc.parity_chain(us))
    np.testing.assert_array_equal(xs[:, tc.K:], tc.parity_chain(us))
    # 1-D input keeps the unbatched API
    np.testing.assert_array_equal(tc.encode(torch.as_tensor(us[0])).numpy(), xs[0])


@pytest.mark.parametrize("method", ["sumprod", "minsum"])
@pytest.mark.parametrize("standard,rate,z", [("802.11n", "1/2", 27),
                                             ("802.16", "5/6", 54)])
def test_decode_matches_jax_same_input(standard, rate, z, method):
    """Same LLRs at 2 dB through the JAX XLA decoder and the port's plain
    decoder: equal iterations and decisions, APP within APP_TOL."""
    jc, tc = _codes(standard, rate, z)
    _, llr = _noisy_llrs(jc, 2.0, 8, seed=11)
    want = jbp.bp_decode(jnp.asarray(llr), jc.graph, 20, method, backend="xla")
    got = tbp.bp_decode(torch.as_tensor(llr), tc.graph, 20, method)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.app.numpy() < 0, np.asarray(want.app) < 0)
    np.testing.assert_allclose(got.app.numpy(), np.asarray(want.app), **APP_TOL)


@pytest.mark.parametrize("standard,rate,method", [("802.16", "1/2", "sumprod"),
                                                  ("802.16", "5/6", "minsum")])
def test_decode_matches_pallas_interpret(standard, rate, method):
    """The TPU kernel itself (interpret mode, z=6) against the port."""
    jc, tc = _codes(standard, rate, 6)
    _, llr = _noisy_llrs(jc, 2.5, 2, seed=5)
    want = bp_decode_pallas(jnp.asarray(llr), jc.graph, 8, method,
                            interpret=True)
    got = tbp.bp_decode(torch.as_tensor(llr), tc.graph, 8, method)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_allclose(got.app.numpy(), np.asarray(want.app), **APP_TOL)


@pytest.mark.parametrize("dectype", ["sumprod", "sumprod2", "minsum"])
def test_decode_matches_oracle_noisy(dectype):
    """The port reproduces the float64 C++ oracle's iteration counts and
    decisions on noisy inputs (tests/test_ldpc.py's protocol)."""
    jc, tc = _codes("802.11n", "1/2", 27)
    _, llr = _noisy_llrs(jc, 2.0, 5, seed=0)
    res = tc.decode(torch.as_tensor(llr), 60, dectype)
    for trial in range(5):
        app_ref, it_ref = jc.decode_ref(llr[trial].astype(np.float64), 60,
                                        dectype)
        assert int(res.iterations[trial]) == it_ref, trial
        np.testing.assert_array_equal(res.app[trial].numpy() < 0, app_ref < 0)


@pytest.mark.parametrize("correct", [0, 1])
def test_lxor_lxfb_vs_oracle_and_jax(correct):
    rng = np.random.default_rng(1 + correct)
    a, b = rng.normal(0, 4, 2)
    got = float(tbp.lxor(torch.tensor(a, dtype=torch.float32),
                         torch.tensor(b, dtype=torch.float32), bool(correct)))
    np.testing.assert_allclose(got, oracle.lxor(a, b, correct),
                               rtol=1e-6, atol=1e-9)
    # sign(0) = +1: the zero operand passes the other's sign through
    z0 = tbp.lxor(torch.tensor([0.0, -2.0]), torch.tensor([-3.0, 0.0]), False)
    np.testing.assert_array_equal(z0.numpy(), [0.0, 0.0])
    L = rng.normal(0, 4, (7, 5)).astype(np.float32)
    ext, total = tbp.lxfb(torch.as_tensor(L), bool(correct))
    jext, jtotal = jbp.lxfb(jnp.asarray(L), bool(correct))
    np.testing.assert_allclose(ext.numpy(), np.asarray(jext), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(total.numpy(), np.asarray(jtotal), rtol=1e-5,
                               atol=1e-6)
    for col in range(L.shape[1]):
        total_ref, ext_ref = oracle.lxfb(L[:, col].astype(np.float64), correct)
        np.testing.assert_allclose(ext.numpy()[:, col], ext_ref, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(total[col]), total_ref, rtol=1e-5,
                                   atol=1e-6)


def test_bp_decode_trace_matches_jax_and_decode():
    jc, tc = _codes("802.11n", "1/2", 27)
    xs, llr = _noisy_llrs(jc, 2.5, 8, seed=5)
    n_it = 30
    traj, it = tbp.bp_decode_trace(torch.as_tensor(llr), tc.graph, n_it)
    jtraj, jit = jbp.bp_decode_trace(jnp.asarray(llr), jc.graph, n_it)
    assert traj.shape == (n_it, 8, tc.N)
    np.testing.assert_array_equal(it.numpy(), np.asarray(jit))
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), **APP_TOL)
    res = tbp.bp_decode(torch.as_tensor(llr), tc.graph, n_it)
    np.testing.assert_array_equal(it.numpy(), res.iterations.numpy())
    # the plain decode freezes a codeword at its stop: the trace's last
    # entry is exactly the decode's APP
    assert torch.equal(traj[-1], res.app)
    assert int(((traj[-1] < 0).numpy() != xs.astype(bool)).sum()) == 0


def test_batch_contracts():
    """(A, B, Nv) and 1-D inputs, through bp_decode (both values of
    bp_kernel; on the CPU both are the plain decode) and LdpcCode.decode."""
    _, tc = _codes("802.16", "1/2", 6)
    us = np.random.default_rng(7).integers(0, 2, (2, 3, tc.K))
    xs = tc.encode(torch.as_tensor(us))
    assert xs.shape == (2, 3, tc.N)
    llr = 10.0 * (0.5 - xs.to(torch.float32))
    for kernel in (True, False):
        r = tbp.bp_decode(llr, tc.graph, 20, "sumprod", bp_kernel=kernel)
        assert r.app.shape == (2, 3, tc.N) and r.iterations.shape == (2, 3)
        assert bool((r.iterations == 0).all())
        assert torch.equal(r.app < 0, xs.bool())
        r1 = tbp.bp_decode(llr[1, 2], tc.graph, 20, "sumprod", bp_kernel=kernel)
        assert r1.app.shape == (tc.N,) and r1.iterations.shape == ()
        assert torch.equal(r1.app, r.app[1, 2])
    r = tc.decode(llr.numpy(), 20, "minsum")
    assert r.app.shape == (2, 3, tc.N) and bool((r.iterations == 0).all())


def test_kernel_wrapper_on_cpu_and_its_checks():
    """On a CPU tensor the K4 wrapper is the plain decode and launches
    nothing; its argument checks; the graph tables it hands the kernel."""
    _, tc = _codes("802.11n", "1/2", 27)
    _, llr = _noisy_llrs(tc, 2.0, 4, seed=3)
    ch = torch.as_tensor(llr)
    before = counters()["k4.launches"]
    got = bp_cuda.bp_decode_kernel(ch, tc.graph, 30, True, 0.7)
    want = bp_cuda.bp_decode_ref(ch, tc.graph, 30, True, 0.7)
    assert counters()["k4.launches"] == before
    assert torch.equal(got.app, want.app)
    assert torch.equal(got.iterations, want.iterations)
    with pytest.raises(ValueError):
        bp_cuda.bp_decode_kernel(ch.to("meta"), tc.graph, 30, True, 0.7)
    with pytest.raises(ValueError, match="contiguous"):
        bp_cuda._check(torch.zeros(tc.N, 4).t(), tc.graph)
    with pytest.raises(ValueError, match="float32"):
        bp_cuda._check(ch.double(), tc.graph)
    big = tbp.TannerGraph.build(ttables.get_protograph("802.16", "1/2", 1000),
                                1000)
    with pytest.raises(ValueError, match="shared memory"):
        bp_cuda._check(torch.zeros(1, big.Nv), big)
    # every configuration the repo runs fits the kernel
    for cfg in GRAPH_CONFIGS + [("802.16", "3/4", 150, "B")]:
        g = tbp.TannerGraph.build(ttables.get_protograph(*cfg), cfg[2])
        bp_cuda._check(torch.zeros(1, g.Nv), g)
    # the CSR tables list each column's and each row's edges in ascending id
    g = tc.graph
    t = bp_cuda._table_arrays(g)
    shift, t = t[:g.E], t[g.E:]
    col_ptr, t = t[:g.Np + 1], t[g.Np + 1:]
    col_ids, t = t[:g.E], t[g.E:]
    row_ptr, row_ids = t[:g.Mp + 1], t[g.Mp + 1:]
    np.testing.assert_array_equal(shift, g.edge_shift)
    for j in range(g.Np):
        np.testing.assert_array_equal(col_ids[col_ptr[j]:col_ptr[j + 1]],
                                      np.flatnonzero(g.edge_col == j))
    for i in range(g.Mp):
        ids = g.chk_edges[i]
        np.testing.assert_array_equal(row_ids[row_ptr[i]:row_ptr[i + 1]],
                                      ids[ids >= 0])


# ---- K4's "split" variant: two threads a check --------------------------------

@pytest.mark.parametrize("cfg,snr_db", [(("802.11n", "1/2", 27, "A"), 1.5),
                                        (("802.16", "3/4", 150, "B"), 3.5)])
@pytest.mark.parametrize("method", ["sumprod", "minsum"])
def test_split_model_equals_plain_decode(cfg, snr_db, method):
    """The split kernel's order of work (one chain of forward prefixes, one
    of backward suffixes, the extrinsic values dealt out between the two
    threads by the parity of their edge) in plain PyTorch, each row at its
    true degree: bit-equal to `_decode_lanes`, iterations and APP, codewords
    at the cap included. Lxor with the padding value 1e30 is the identity to
    the last bit, which is why the padded trellis of the plain decode and
    the true-degree trellis of the kernels agree."""
    tc = tldpc.get_code(*cfg)
    _, llr = _noisy_llrs(tc, snr_db, 3, seed=11)
    ch = torch.as_tensor(llr)
    corr = method != "minsum"
    want = tbp._decode_lanes(ch, tc.graph, 6, corr, 0.7)
    got = bp_cuda.decode_split_model(ch, tc.graph, 6, corr, 0.7)
    assert torch.equal(got.iterations, want.iterations)
    assert torch.equal(got.app, want.app)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 8, 20])
@pytest.mark.parametrize("correction", [True, False])
def test_split_check_model_equals_lxfb(d, correction):
    """One check row of degree d, degree 1 and 2 included, against the
    padded forward-backward trellis `lxfb` (pad rows hold 1e30): extrinsic
    values and aggregate bit for bit."""
    rng = np.random.default_rng(d)
    rows = torch.as_tensor(rng.normal(scale=4.0, size=(d, 5, 9)).astype(np.float32))
    rows[0, 0, 0] = 0.0                      # sign(0) is +1 inside Lxor
    padded = torch.cat([rows, torch.full((3, 5, 9), 1e30)])
    want_ext, want_aggr = tbp.lxfb(padded, correction)
    ext, aggr = bp_cuda.split_check_model(list(rows), correction, 0.7)
    scale = 1.0 if correction else 0.7
    assert torch.equal(torch.stack(ext), want_ext[:d] * scale)
    assert torch.equal(aggr, want_aggr)


def test_k4_shared_bytes_and_variant_table():
    """`shared_bytes` per layout (the split variant holds a third (E, z)
    plane), the table that picks a variant and a block size from the graph,
    and the compiled kernel a launch takes."""
    g = tldpc.get_code("802.11n", "1/2", 27).graph
    tables = 4 * (3 * g.E + g.Np + g.Mp + 2)
    assert bp_cuda.shared_bytes(g, "check_thread") == tables + 4 * (2 * g.E * g.z
                                                                    + 2 * g.Nv)
    assert bp_cuda.shared_bytes(g, "split") == tables + 4 * (3 * g.E * g.z + 2 * g.Nv)
    assert bp_cuda.shared_bytes(g) == bp_cuda.shared_bytes(g, "split")
    with pytest.raises(ValueError, match="variant"):
        bp_cuda.shared_bytes(g, "warp")
    want = {("802.11n", "1/2", 27, "A"): ("split", 704),
            ("802.11n", "5/6", 81, "A"): ("split", 704),
            ("802.16", "1/2", 27, "A"): ("split", 704),
            ("802.16", "1/2", 150, "A"): ("check_thread", 1024),
            ("802.16", "3/4", 150, "B"): ("check_thread", 928)}
    for cfg, (variant, threads) in want.items():
        gr = tldpc.get_code(*cfg).graph
        assert bp_cuda.k4_variant(gr) == variant
        assert bp_cuda.block_threads(gr, variant) == threads
        assert bp_cuda.shared_bytes(gr) <= bp_cuda.MAX_SHARED
    # the split variant's third plane fits at 802.16 r=3/4 B z=150 ...
    big = tldpc.get_code("802.16", "3/4", 150, "B").graph
    assert bp_cuda.shared_bytes(big, "split") == 188384 <= bp_cuda.MAX_SHARED
    # ... and a graph that fits one thread a check but not the third plane is
    # refused by name and sent to "check_thread" by the table
    wide = tbp.TannerGraph.build(ttables.get_protograph("802.16", "1/2", 250), 250)
    assert (bp_cuda.shared_bytes(wide, "check_thread") <= bp_cuda.MAX_SHARED
            < bp_cuda.shared_bytes(wide, "split"))
    assert bp_cuda.k4_variant(wide) == "check_thread"
    bp_cuda._check(torch.zeros(1, wide.Nv), wide)
    with pytest.raises(ValueError, match="shared memory"):
        bp_cuda._check(torch.zeros(1, wide.Nv), wide, "split")
    # two blocks an SM: "check_thread" up to 512 threads; "split" for a batch
    # of one wave of short checks
    assert bp_cuda.two_blocks_an_sm("check_thread", 352, 512, 132, 8)
    assert not bp_cuda.two_blocks_an_sm("check_thread", 1024, 256, 132, 7)
    assert bp_cuda.two_blocks_an_sm("split", 704, 256, 132, 8)
    assert not bp_cuda.two_blocks_an_sm("split", 704, 512, 132, 8)
    assert not bp_cuda.two_blocks_an_sm("split", 704, 256, 132, 20)
    assert not bp_cuda.two_blocks_an_sm("split", 1024, 256, 132, 8)


def test_k4_wrapper_variant_argument():
    """An unknown variant raises on any device; a CPU tensor runs the plain
    decode whatever variant is named."""
    _, tc = _codes("802.11n", "1/2", 27)
    _, llr = _noisy_llrs(tc, 2.0, 2, seed=5)
    ch = torch.as_tensor(llr)
    want = bp_cuda.bp_decode_ref(ch, tc.graph, 10, True, 0.7)
    for variant in bp_cuda.VARIANTS:
        got = bp_cuda.bp_decode_kernel(ch, tc.graph, 10, True, 0.7, variant=variant)
        assert torch.equal(got.app, want.app)
    with pytest.raises(ValueError, match="variant"):
        bp_cuda.bp_decode_kernel(ch, tc.graph, 10, True, 0.7, variant="warp")


def test_ldpc_config_matches_jax():
    for std, rate, z, p in [("802.11n", "5/6", 81, "A"), ("802.16", "3/4", 150, "B")]:
        a, b = tcfg.LdpcParams(std, rate, z, p), jcfg.LdpcParams(std, rate, z, p)
        assert a.rate_float == b.rate_float
    for bad in (dict(standard="802.11n", z=30), dict(rate="7/8"), dict(ptype="C")):
        with pytest.raises(AssertionError):
            tcfg.LdpcParams(**bad)
    for std, rate, z in [("802.16", "1/2", 150), ("802.11n", "2/3", 27)]:
        K = tldpc.get_code(std, rate, z).K
        a = tcfg.param_calc(4, 1, tcfg.LdpcParams(std, rate, z),
                            tcfg.LdpcParams(std, rate, z).rate_float, 1.0, K)
        b = jcfg.param_calc(4, 1, jcfg.LdpcParams(std, rate, z),
                            jcfg.LdpcParams(std, rate, z).rate_float, 1.0, K)
        assert a[:3] == b[:3] and dataclasses.asdict(a[3]) == dataclasses.asdict(b[3])
        a = tcfg.param_calc_semi_protected(1.0, 2, 0.5, 4, tcfg.LdpcParams(std, rate, z),
                                           0.5, K)
        b = jcfg.param_calc_semi_protected(1.0, 2, 0.5, 4, jcfg.LdpcParams(std, rate, z),
                                           0.5, K)
        assert a[:3] + a[4:] == b[:3] + b[4:]
        assert dataclasses.asdict(a[3]) == dataclasses.asdict(b[3])
