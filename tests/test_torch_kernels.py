"""The port's hand-written kernels against their plain PyTorch versions, on
the card. Every test here is marked `cuda` and skips where torch sees no
card. This file imports neither JAX nor the JAX package, so it also runs
on a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances: the signed FWHT is float32 in both versions, so the kernel
stays within 1e-5 * max|ref| (log2(w) stages of float32 rounding) on every
route and through its two fused SRHT products, and is bit-equal on rows with
entries in {-1, 0, 1}; K2 (the
two-sided form, bf16 operands) is bit-exact on rows with entries in
{-1, 0, 1} up to b = 256 and within chip_smoke.py's relative Frobenius
bound of 1e-3 of its plain version on Gaussian rows; K2 with float32
operands (three bf16 planes, float32 sums; the wgmma kernels and the
mma.sync pass kernels) is bit-equal to the exact
transform on those rows at every width and within 2.5e-6 of the largest
entry of its plain version (two float32 matmuls, TF32 off) on Gaussian
rows, a limit between the kernels' readings (at most 1.81e-6, at 2^20) and
those of a control without the lo plane (at least 3.25e-6); the denoiser tail uses tests/test_denoiser_pallas.py's tolerances (s
to rtol 1e-6, the softmax and energies to rtol 1e-5, since exp and the
sums reassociate), at every section length from 32 to 2^20. The BP decode must give the plain decode's iteration counts
on every codeword, and its decisions and APP (rtol 1e-5, atol 1e-4, the
bound tests/test_bp_pallas.py holds the TPU kernel to) on every codeword
that stopped by parity.
"""

import pytest
import torch

from ldpc_sparc_tpu_torch import (DecodeParams, LdpcParams, SparcDesign,
                                  SparcParams, artifacts, get_code,
                                  ldpc_waterfall_campaign)
from ldpc_sparc_tpu_torch.models import sparc
from ldpc_sparc_tpu_torch.models.ldpc_tables import get_protograph
from ldpc_sparc_tpu_torch.ops import bp_cuda, denoiser_cuda, wht_cuda
from ldpc_sparc_tpu_torch.ops.bp import TannerGraph
from ldpc_sparc_tpu_torch.utils import bits as bitops
from ldpc_sparc_tpu_torch.utils.tracing import counters, reset

from freeze_checks import check_freeze_step, where_freeze_decode


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("log_w", [0, 1, 3, 5, 10, 12, 13, 15, 19, 22])
@pytest.mark.parametrize("mode", ["pre", "post", "none"])
def test_fwht_signed_matches_plain(log_w, mode):
    dev = _card()
    w = 1 << log_w
    E, B = 2, (2 if log_w < 22 else 1)
    gen = torch.Generator(device=dev).manual_seed(log_w)
    x = torch.randn(B * E, w, generator=gen, device=dev)
    signs = None if mode == "none" else (
        torch.randint(0, 2, (E, w), generator=gen, device=dev) * 2 - 1).float()
    before = counters()["k1.launches"]
    got = wht_cuda.fwht_signed(x, signs, mode == "pre")
    assert counters()["k1.launches"] == before + 1
    want = wht_cuda.fwht_signed_ref(x, signs, mode == "pre")
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


ROUTE_CASES = [(log_w, route) for route in wht_cuda.ROUTES
               for log_w in range(wht_cuda.ROUTE_LOG_W[route][0],
                                  wht_cuda.ROUTE_LOG_W[route][1] + 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("log_w,route", ROUTE_CASES)
@pytest.mark.parametrize("mode", ["pre", "post", "none"])
def test_fwht_signed_every_route_matches_plain(log_w, route, mode):
    """Every width of every route, with 1, 2 and 192 sign rows: Gaussian rows
    within 1e-5 of the largest entry, rows with entries in {-1, 0, 1} bit
    for bit (every partial sum is an integer below 2^24)."""
    dev = _card()
    w = 1 << log_w
    gen = torch.Generator(device=dev).manual_seed(100 * log_w + len(route))
    for E in (1, 2, 192):
        rows = E * (2 if E < 192 and log_w < 22 else 1)
        signs = None if mode == "none" else (
            torch.randint(0, 2, (E, w), generator=gen, device=dev) * 2 - 1).float()
        for kind in ("ternary", "gaussian"):
            x = (torch.randint(-1, 2, (rows, w), generator=gen, device=dev).float()
                 if kind == "ternary" else
                 torch.randn(rows, w, generator=gen, device=dev))
            before = counters()["k1.launches"]
            got = wht_cuda.fwht_signed(x, signs, mode == "pre", route=route)
            assert counters()["k1.launches"] == before + 1
            want = wht_cuda.fwht_signed_ref(x, signs, mode == "pre")
            torch.cuda.synchronize()
            if kind == "ternary":
                assert torch.equal(got, want), (E, kind)
            else:
                assert float((got - want).abs().max()) \
                    <= 1e-5 * float(want.abs().max()), (E, kind)
            del x, got, want


@pytest.mark.cuda
def test_fwht_signed_default_route_is_the_table():
    """route=None gives what the table's route gives, bit for bit."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(3)
    for log_w in (9, 15, 17, 18, 19, 20):
        x = torch.randn(4, 1 << log_w, generator=gen, device=dev)
        route = wht_cuda.fwht_route(log_w)[0]
        assert torch.equal(wht_cuda.fwht_signed(x, None, False),
                           wht_cuda.fwht_signed(x, None, False, route=route))
    with pytest.raises(ValueError):
        wht_cuda.fwht_signed(x, None, False, route="block")


def _srht_case(rows, E, k, log_w, dev, seed, kind):
    w = 1 << log_w
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.stack([torch.randperm(w, generator=gen, device=dev)[:k].sort().values
                       for _ in range(E)])
    signs = (torch.randint(0, 2, (E, w), generator=gen, device=dev) * 2 - 1).float()
    if kind == "ternary":
        vals = torch.randint(-1, 2, (rows, k), generator=gen, device=dev).float()
        x = torch.randint(-1, 2, (rows, w), generator=gen, device=dev).float()
    else:
        vals = torch.randn(rows, k, generator=gen, device=dev)
        x = torch.randn(rows, w, generator=gen, device=dev)
    return idx, signs, vals, x


# (rows, E, k, log2 w): the headline's and the SC decode's index sides, one
# index and all of them at a width of each on-chip route, and a width the
# table sends to two passes (composed in device memory around them)
SRHT_CASES = [(256, 1, 9216, 19), (12288, 192, 332, 15),
              (6, 3, 1, 5), (6, 3, 32, 5), (4, 2, 1, 13), (4, 2, 1 << 13, 13),
              (4, 2, 1, 15), (4, 2, 1 << 15, 15), (4, 2, 1, 16),
              (4, 2, 1 << 16, 16), (2, 1, 1, 19), (2, 1, 1 << 19, 19),
              (4, 2, 700, 0), (4, 2, 1000, 18), (2, 1, 5000, 20)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,E,k,log_w", SRHT_CASES)
@pytest.mark.parametrize("signed", ["signs", "none"])
def test_fused_srht_products_match_plain(rows, E, k, log_w, signed):
    """srht_scatter_fwht and srht_fwht_gather against the zero fill, scatter_,
    transform, gather composition: bit for bit on ternary rows, 1e-5 of the
    largest entry on Gaussian rows; int32 and int64 indices; one K1 launch
    each; both sign conventions."""
    dev = _card()
    k = min(k, 1 << log_w)
    for kind in ("ternary", "gaussian"):
        idx, signs, vals, x = _srht_case(rows, E, k, log_w, dev, log_w + k, kind)
        sg = signs if signed == "signs" else None
        for apply_pre in (False, True):
            for ix in (idx, idx.to(torch.int32)):
                before = counters()["k1.launches"]
                got_s = wht_cuda.srht_scatter_fwht(vals, ix, sg, 1 << log_w,
                                                   apply_pre=apply_pre)
                got_g = wht_cuda.srht_fwht_gather(x, sg, ix, apply_pre=apply_pre)
                assert counters()["k1.launches"] == before + 2
            want_s = wht_cuda.srht_scatter_fwht_ref(vals, idx, sg, 1 << log_w,
                                                    apply_pre)
            want_g = wht_cuda.srht_fwht_gather_ref(x, sg, idx, apply_pre)
            torch.cuda.synchronize()
            for got, want in ((got_s, want_s), (got_g, want_g)):
                assert got.shape == want.shape
                if kind == "ternary":
                    assert torch.equal(got, want), (kind, apply_pre)
                else:
                    assert float((got - want).abs().max()) \
                        <= 1e-5 * float(want.abs().max()), (kind, apply_pre)
            del got_s, got_g, want_s, want_g


@pytest.mark.cuda
def test_fused_srht_products_reject_bad_arguments():
    dev = _card()
    idx = torch.tensor([[0, 3, 5]], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="outside"):
        wht_cuda.srht_fwht_gather(torch.zeros(2, 8, device=dev), None,
                                  torch.tensor([[0, 3, 8]], device=dev))
    with pytest.raises(ValueError, match="lies on"):
        wht_cuda.srht_scatter_fwht(torch.zeros(2, 3, device=dev), idx.cpu(), None, 8)
    with pytest.raises(ValueError, match="two_pass"):
        wht_cuda.srht_fwht_gather(torch.zeros(2, 1 << 10, device=dev), None, idx,
                                  route="two_pass")
    with pytest.raises(ValueError):
        wht_cuda.srht_fwht_gather(torch.zeros(2, 8, device=dev), None, idx,
                                  route="cluster")
    assert wht_cuda.active_clusters(19) >= 1


@pytest.mark.cuda
def test_fwht_signed_rejects_bad_arguments():
    dev = _card()
    with pytest.raises(ValueError):
        wht_cuda.fwht_signed(torch.zeros(2, 12, device=dev), None, True)
    with pytest.raises(ValueError):
        wht_cuda.fwht_signed(torch.zeros(3, 16, device=dev),
                             torch.ones(2, 16, device=dev), True)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [32, 64, 128, 512, 4096])
def test_fused_denoise_update_matches_plain(M):
    dev = _card()
    B, L = 3, 16
    gen = torch.Generator(device=dev).manual_seed(M)
    beta = torch.rand(B, L * M, generator=gen, device=dev)
    azo = 4.0 * torch.randn(B, L * M, generator=gen, device=dev)
    tau = 0.5 + torch.rand(B, L, generator=gen, device=dev)
    got = denoiser_cuda.fused_denoise_update(beta, azo, tau, M)
    want = denoiser_cuda.fused_denoise_update_ref(beta, azo, tau, M)
    torch.cuda.synchronize()
    for g, w, rtol in zip(got, want, (1e-6, 1e-5, 1e-5)):
        torch.testing.assert_close(g, w, rtol=rtol, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("M,L,route", [(1 << 13, 16, None), (1 << 14, 8, None),
                                       (1 << 15, 4, None), (1 << 16, 4, None),
                                       (1 << 16, 4, "block"), (1 << 20, 2, None),
                                       (1 << 20, 2, "block")])
def test_fused_denoise_update_matches_plain_at_long_sections(M, L, route):
    """From M = 8192 one block walks a section three times, in shared memory
    up to 2^15 (the default there) and re-reading s above (route "block");
    from 2^16 the default is a cluster of blocks a section. The per-entry
    operations are the register kernel's, so s is bit-equal and only the
    sums reassociate: beta_new and the energies within rtol 1e-5, with an
    atol (1e-12) far below a softmax entry of 2^20, so that every entry is
    held."""
    dev = _card()
    B = 2
    gen = torch.Generator(device=dev).manual_seed(M)
    beta = torch.softmax(3 * torch.randn(B, L, M, generator=gen, device=dev),
                         -1).reshape(B, L * M)
    azo = 4.0 * torch.randn(B, L * M, generator=gen, device=dev)
    tau = 0.5 + torch.rand(B, L, generator=gen, device=dev)
    before = counters()["k3.launches"]
    got = denoiser_cuda.fused_denoise_update(beta, azo, tau, M, route)
    assert counters()["k3.launches"] == before + 1
    want = denoiser_cuda.fused_denoise_update_ref(beta, azo, tau, M)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("M,B,L", [(1 << 16, 7, 19), (1 << 17, 4, 8), (1 << 18, 3, 3),
                                   (1 << 19, 2, 3), (1 << 20, 1, 5), (1 << 22, 1, 2)],
                         ids=lambda v: str(v))
def test_cluster_route_matches_plain_and_repeats_its_bits(M, B, L):
    """The cluster route (C = 4, 8, 16 blocks a section with shares of 2^14;
    16 with shares of 2^15, and of 2^16 and 2^18 with the rest of a share
    re-read) against the plain version at phase 21's tolerances, on section
    counts that are no multiple of the card's 132 SMs (133 at 2^16); a
    second run gives the same bits, since the partials combine in
    block-rank order."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(M + B)
    beta = torch.softmax(3 * torch.randn(B, L, M, generator=gen, device=dev),
                         -1).reshape(B, L * M)
    azo = 2 * torch.randn(B, L * M, generator=gen, device=dev)
    tau = 0.5 + 1.5 * torch.rand(B, L, generator=gen, device=dev)
    before = counters()["k3.launches"]
    got = denoiser_cuda.fused_denoise_update(beta, azo, tau, M)
    again = denoiser_cuda.fused_denoise_update(beta, azo, tau, M, "cluster")
    assert counters()["k3.launches"] == before + 2
    want = denoiser_cuda.fused_denoise_update_ref(beta, azo, tau, M)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("M,B,L,route,mask", [
    (512, 5, 16, None, "some"), (512, 5, 16, None, "none"), (512, 5, 16, None, "all"),
    (32, 4, 8, None, "some"), (64, 4, 8, None, "some"), (1 << 13, 4, 4, None, "some"),
    (1 << 16, 3, 2, "block", "some")], ids=lambda v: str(v))
def test_k3_freeze_copies_stopped_rows(M, B, L, route, mask):
    """The mask on the register route (M 32 to 4096) and the long one (in
    shared memory to 2^15, re-reading s above; the cluster route:
    tests/test_torch_k3_cluster.py): live rows bit-equal to the unmasked
    kernel, stopped rows' beta and s copied and their energies those of the
    step that wrote beta, bit for bit; one freeze launch counted."""
    dev = _card()
    stopped = {"some": None, "none": torch.zeros(B, dtype=torch.bool, device=dev),
               "all": torch.ones(B, dtype=torch.bool, device=dev)}[mask]
    before = counters()
    check_freeze_step(dev, B, L, M, route, stopped)
    torch.cuda.synchronize()
    after = counters()
    assert [after[k] - before[k] for k in ("k3.launches", "k3.freeze_launches")] == [3, 1]


@pytest.mark.cuda
def test_amp_decode_freeze_on_the_card_matches_the_where_loop():
    """K1 + K3 at L=64, M=64, 8 codewords that stop at different iterations,
    some at the cap: every output of `amp_decode` (beta and s frozen inside
    K3) equal bit for bit to the loop that froze them by `torch.where`, and
    every K3 launch of the decode a freeze launch."""
    dev = _card()
    params, decode, awgn_var = SparcParams(P=15.0, R=1.2, L=64, M=64), DecodeParams(t_max=20), 2.5
    design = SparcDesign.for_params(params, awgn_var, 3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    bits = bitops.random_bits(gen, 8 * params.bit_len).reshape(8, -1)
    beta0 = bitops.bits_to_msg_vector(bits, params.M)
    y = sparc.awgn_channel(design.ab(beta0), awgn_var, gen)
    reset("k3.launches", "k3.freeze_launches")
    got = sparc.amp_decode(y, design, params, decode, awgn_var, beta0)
    torch.cuda.synchronize()
    assert counters()["k3.freeze_launches"] == counters()["k3.launches"] == decode.t_max - 1
    want = where_freeze_decode(y, design, params, decode, awgn_var, beta0)
    assert len(set(want[3].tolist())) > 2
    assert all(torch.equal(g, w) for g, w in zip(
        (got.beta, got.beta_mmse, got.s, got.t_final, got.nmse, got.psi), want))


@pytest.mark.cuda
def test_cluster_route_is_refused_below_its_range():
    dev = _card()
    beta = torch.zeros(1, 1 << 15, device=dev)
    with pytest.raises(ValueError, match="cluster route"):
        denoiser_cuda.fused_denoise_update(beta, beta, torch.ones(1, 1, device=dev),
                                           1 << 15, "cluster")


@pytest.mark.cuda
def test_decode_at_sections_of_2_16_through_the_cluster_route():
    """A plain SPARC at L=16, M=2^16 (LM = 2^20), R=0.5, P=15, awgn_var 1,
    t_max 25, 4 codewords: through K1 + K3's cluster route (launched at
    every iteration, frozen rows included) and through the plain path, the
    same decisions on every codeword that converges and t_final within 1."""
    dev = _card()
    params, decode = SparcParams(P=15.0, R=0.5, L=16, M=1 << 16), DecodeParams(t_max=25)
    design = SparcDesign.for_params(params, 1.0, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    bits = bitops.random_bits(gen, 4 * params.bit_len).reshape(4, -1)
    y = sparc.awgn_channel(design.ab(bitops.bits_to_msg_vector(bits, params.M)), 1.0, gen)
    k3 = counters()["k3.launches"]
    beta_k, t_k = sparc.decode_batch(y, design, params, decode, 1.0)
    assert counters()["k3.launches"] - k3 == decode.t_max - 1
    beta_p, t_p = sparc.decode_batch(y, design, params, decode, 1.0,
                                     fused_denoiser=False, fwht_kernel=False)
    conv = t_p < decode.t_max - 1
    assert int(conv.sum()) == 4
    assert torch.equal(beta_k[conv], beta_p[conv]) and int((t_k - t_p).abs().max()) <= 1
    assert torch.equal(bitops.msg_vector_to_bits(beta_k, params.M), bits)


CODES = {
    "plain": dict(P=15.0, R=1.0, L=32, M=128),
    "offset1": dict(P=15.0, R=1.3, L=48, M=16),
    "sc": dict(P=15.0, R=1.0, L=64, M=16, spatially_coupled=True, omega=2,
               Lambda=4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CODES))
def test_design_products_match_plain(name):
    dev = _card()
    td = SparcDesign.for_params(SparcParams(**CODES[name]), 1.0, 5, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    beta = torch.randn(4, td.LM, generator=gen, device=dev)
    z = torch.randn(4, td.n, generator=gen, device=dev)
    for got, want in ((td.ab(beta), td.ab(beta, fwht_kernel=False)),
                      (td.az(z), td.az(z, fwht_kernel=False))):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_decode_kernel_path_matches_plain_path():
    """The same y through both kernels and through the plain path: the same
    decisions and iteration counts, and one launch per batched product."""
    dev = _card()
    params, decode, t_max = SparcParams(**CODES["plain"]), DecodeParams(t_max=8), 8
    design = SparcDesign.for_params(params, 1.0, 5, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    bits = bitops.random_bits(gen, 4 * params.bit_len).reshape(4, -1)
    y = sparc.awgn_channel(design.ab(bitops.bits_to_msg_vector(bits, params.M)),
                           1.0, gen)
    k1, k3 = counters()["k1.launches"], counters()["k3.launches"]
    beta_k, t_k = sparc.decode_batch(y, design, params, decode, 1.0)
    assert counters()["k1.launches"] - k1 == 2 * (t_max - 1) - 1
    assert counters()["k3.launches"] - k3 == t_max - 1
    beta_p, t_p = sparc.decode_batch(y, design, params, decode, 1.0,
                                     fused_denoiser=False, fwht_kernel=False)
    assert torch.equal(beta_k, beta_p) and torch.equal(t_k, t_p)
    assert torch.equal(bitops.msg_vector_to_bits(beta_k, params.M), bits)


# ---- the block-indexed design products: the column select and sum in K1 -------

# designs whose columns are not the identity, on K1's block route
BLOCK_CODES = {
    "sc_w12": dict(P=15.0, R=1.0, L=256, M=128, spatially_coupled=True, omega=3,
                   Lambda=8),
    # the benchmark's SC cell: E = 192 blocks of 2^15 (4 rows here)
    "sc_w15": dict(P=15.0, R=1.5, L=2048, M=512, spatially_coupled=True, omega=6,
                   Lambda=32),
}


def _within(got, want, rel=1e-5):
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= rel * float(want.abs().max())


def _in_order_sum(parts, ptr, blocks):
    """(B, E, d) parts summed into the table's segments, block order."""
    p, bl = ptr.tolist(), blocks.tolist()
    out = parts.new_zeros(parts.shape[0], len(p) - 1, parts.shape[2])
    for s in range(len(p) - 1):
        for e in bl[p[s]:p[s + 1]]:
            out[:, s] += parts[:, e]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BLOCK_CODES))
def test_block_indexed_products_match_plain(name):
    """ab and az take the block-indexed route, one K1 launch a product, and
    match the plain path within 1e-5 of the largest entry. On the column
    side they equal the route they replace: ab's gathered parts bit for
    bit, and az bit for bit against today's fused parts added in block
    order."""
    dev = _card()
    td = SparcDesign.for_params(SparcParams(**BLOCK_CODES[name]), 1.0, 5, device=dev)
    assert td.offset == 0 and td.E > 1
    gen = torch.Generator(device=dev).manual_seed(0)
    beta = torch.randn(4, td.LM, generator=gen, device=dev)
    z = torch.randn(4, td.n, generator=gen, device=dev)
    for prod, v in ((td.ab, beta), (td.az, z)):
        before = counters()
        got = prod(v)
        after = counters()
        assert after["k1.launches"] - before["k1.launches"] == 1
        assert after["k1.block_products"] - before["k1.block_products"] == 1
        _within(got, prod(v, fwht_kernel=False))
    xb, zb = beta.reshape(4, td.Lc, td.Mc), z.reshape(4, td.Lr, td.Mr)
    table = (td._col_ptr, td._col_blocks)
    got = wht_cuda.srht_fwht_gather_blocks(xb.contiguous(), td.signs, td._idx32,
                                           *table) * td.scale[:, None]
    assert torch.equal(got, td._fwd_blocks(td._select(xb, td.cols, td._cols_t,
                                                      td.Lc)))
    want = _in_order_sum(td._adj_blocks(td._select(zb, td.rows, td._rows_t, td.Lr)),
                         *table)
    assert torch.equal(td.az(z).reshape(want.shape), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BLOCK_CODES))
def test_window_sum_repeats_its_bits(name):
    """az, whose column side is summed, adds in block order with no float
    atomics: two calls, the same bits."""
    dev = _card()
    td = SparcDesign.for_params(SparcParams(**BLOCK_CODES[name]), 1.0, 5, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    z = torch.randn(64, td.n, generator=gen, device=dev)
    assert torch.equal(td.az(z), td.az(z))


@pytest.mark.cuda
def test_block_products_count_in_an_sc_decode_and_none_in_a_flagship_decode():
    """k1.block_products: 2 (t_max - 1) - 1 = 77 for an SC decode of t_max 40
    and 1 for its encode; 0 for a one-block (flagship) design."""
    dev = _card()
    for kw, t_max, want in ((BLOCK_CODES["sc_w12"], 40, 78),
                            (dict(P=15.0, R=1.0, L=1024, M=512), 30, 0)):
        params = SparcParams(**kw)
        design = SparcDesign.for_params(params, 1.0, 5, device=dev)
        gen = torch.Generator(device=dev).manual_seed(2)
        bits = bitops.random_bits(gen, 4 * params.bit_len).reshape(4, -1)
        before = counters()
        y = sparc.awgn_channel(design.ab(bitops.bits_to_msg_vector(bits, params.M)),
                               1.0, gen)
        sparc.decode_batch(y, design, params, DecodeParams(t_max=t_max), 1.0)
        after = counters()
        assert after["k1.block_products"] - before["k1.block_products"] == want
        assert after["k1.launches"] - before["k1.launches"] == 2 * (t_max - 1)


# designs that keep today's route: a 2^16 window (the cluster route), an
# offset-1 window, complex values, a tall PA design (n = 512 rows of one row
# block that every block sums into)
BYPASS_CODES = {
    "pa_tall": dict(P=15.0, R=0.5, L=64, M=16, power_allocated=True, B=4,
                    R_PA_ratio=1.0),
    "sc_cluster_w16": dict(P=15.0, R=1.5, L=512, M=512, spatially_coupled=True,
                           omega=2, Lambda=4),
    "sc_offset1": dict(P=15.0, R=1.0, L=48, M=16, spatially_coupled=True, omega=2,
                       Lambda=4),
    "sc_complex": dict(P=15.0, R=1.0, L=256, M=128, spatially_coupled=True,
                       omega=3, Lambda=8, is_complex=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BYPASS_CODES) + ["sc_2mm"])
def test_other_designs_keep_todays_route(name):
    """The cluster route, offset-1 windows, complex values, a tall design
    and K2's mode take no block-indexed product, and still match their
    plain paths."""
    dev = _card()
    kw = BLOCK_CODES["sc_w12"] if name == "sc_2mm" else BYPASS_CODES[name]
    mode = "2mm" if name == "sc_2mm" else "ms"
    td = SparcDesign.for_params(SparcParams(**kw), 1.0, 5, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    beta = torch.randn(3, td.LM, generator=gen, device=dev)
    z = torch.randn(3, td.n, generator=gen, device=dev)
    if kw.get("is_complex"):
        beta = torch.complex(beta, torch.randn(3, td.LM, generator=gen, device=dev))
        z = torch.complex(z, torch.randn(3, td.n, generator=gen, device=dev))
    before = counters()["k1.block_products"]
    for prod, v in ((td.ab, beta), (td.az, z)):
        # "2mm" keeps K1 below K2's widths (2^12 here), whose plain version
        # is "ms"'s
        _within(prod(v, fwht_mode=mode), prod(v, fwht_kernel=False))
    assert counters()["k1.block_products"] == before


# ---- K4: the whole LDPC BP decode ------------------------------------------
# (code, method, SNR in dB of the random noisy inputs): the largest check
# degree (802.11n r=5/6, dc_max 20), the largest z, and the largest shared
# state (802.16 r=3/4 B z=150, over 48 KB, at an SNR where nearly every
# codeword stops by parity, so the gate holds its decisions).
BP_CASES = {
    "11n-r1/2-z27-sumprod": (("802.11n", "1/2", 27, "A"), "sumprod", 1.5),
    "11n-r5/6-z81-minsum": (("802.11n", "5/6", 81, "A"), "minsum", 5.5),
    "16-r1/2-z150-sumprod": (("802.16", "1/2", 150, "A"), "sumprod", 1.5),
    "16-r3/4B-z150-sumprod": (("802.16", "3/4", 150, "B"), "sumprod", 4.5),
}
BP_ITERS = 50


def _bp_inputs(cfg, snr_db, batch, dev, seed=0):
    code = get_code(*cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = code.encode(torch.randint(0, 2, (batch, code.K), generator=gen, device=dev))
    sigma2 = 10 ** (-snr_db / 10)
    y = (1 - 2 * x.float()) + sigma2 ** 0.5 * torch.randn(
        batch, code.N, generator=gen, device=dev)
    return code, x, (2 / sigma2 * y).contiguous()


def _bp_gate(got, want, max_iters):
    """Iterations equal everywhere; decisions equal and APP within rtol 1e-5
    / atol 1e-4 on every codeword that stopped by parity (a codeword that
    runs to max_iters may drift apart at float32 rounding)."""
    assert torch.equal(got.iterations, want.iterations)
    stopped = want.iterations < max_iters
    assert torch.equal(got.app[stopped] < 0, want.app[stopped] < 0)
    torch.testing.assert_close(got.app[stopped], want.app[stopped], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [None, "check_thread", "split"])
@pytest.mark.parametrize("batch", [1, 3, 256])
@pytest.mark.parametrize("name", sorted(BP_CASES))
def test_bp_decode_kernel_matches_plain(name, batch, variant):
    dev = _card()
    cfg, method, snr = BP_CASES[name]
    code, x, llr = _bp_inputs(cfg, snr, batch, dev)
    correction = method != "minsum"
    before = counters()["k4.launches"]
    got = bp_cuda.bp_decode_kernel(llr, code.graph, BP_ITERS, correction, 0.7,
                                   variant=variant)
    assert counters()["k4.launches"] == before + 1
    want = bp_cuda.bp_decode_ref(llr, code.graph, BP_ITERS, correction, 0.7)
    torch.cuda.synchronize()
    assert got.app.shape == (batch, code.N) and got.iterations.dtype == torch.int32
    _bp_gate(got, want, BP_ITERS)


@pytest.mark.cuda
def test_bp_decode_kernel_matches_plain_at_campaign_shape():
    """The waterfall campaign's decode: 802.16 r=1/2 z=27, sumprod2, batch
    512, at most 200 iterations, at an SNR where codewords stop anywhere
    from the first iteration to well past 100."""
    dev = _card()
    code, x, llr = _bp_inputs(("802.16", "1/2", 27, "A"), 2.5, 512, dev)
    got = bp_cuda.bp_decode_kernel(llr, code.graph, 200, True, 0.7)
    want = bp_cuda.bp_decode_ref(llr, code.graph, 200, True, 0.7)
    torch.cuda.synchronize()
    _bp_gate(got, want, 200)


K4_EQUAL_CASES = [(name, batch, BP_ITERS) for name in sorted(BP_CASES)
                  for batch in (1, 3, 256, 512, 1000)] + [("campaign", 512, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,batch,iters", K4_EQUAL_CASES)
def test_bp_decode_kernel_variants_are_bit_equal(name, batch, iters):
    """"split" runs every Lxor of "check_thread" on the same operands in the
    same order: iterations and APP are `torch.equal` on every codeword,
    those at the cap included, with either compiled kernel (two blocks an SM
    or one) and with more blocks than the card holds at once (batch 1000)."""
    dev = _card()
    cfg, method, snr = (BP_CASES[name] if name != "campaign"
                        else (("802.16", "1/2", 27, "A"), "sumprod", 2.5))
    code, x, llr = _bp_inputs(cfg, snr, batch, dev)
    correction = method != "minsum"
    want = bp_cuda.bp_decode_kernel(llr, code.graph, iters, correction, 0.7,
                                    variant="check_thread")
    for kw in (dict(variant="split", two_blocks=True),
               dict(variant="split", two_blocks=False),
               dict(variant="check_thread", two_blocks=False)):
        got = bp_cuda.bp_decode_kernel(llr, code.graph, iters, correction, 0.7, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got.iterations, want.iterations), kw
        assert torch.equal(got.app, want.app), kw


@pytest.mark.cuda
def test_lxor_shortcuts_are_not_taken():
    """The kernel's Lxor is the plain one (expf, log1pf, no fast math): one
    dependent Lxor on a warp takes a measurable, positive time, and the
    sum-product chain costs more than the min-sum chain."""
    _card()
    sp = bp_cuda.lxor_chain_ms(50_000, True)
    ms = bp_cuda.lxor_chain_ms(50_000, False)
    assert sp > ms > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BP_CASES))
def test_bp_decode_kernel_noiseless_fixed_point(name):
    dev = _card()
    cfg, method, _ = BP_CASES[name]
    code = get_code(*cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = code.encode(torch.randint(0, 2, (5, code.K), generator=gen, device=dev))
    res = code.decode(10.0 * (0.5 - x.float()), 200, method)
    assert torch.equal(res.iterations, torch.zeros_like(res.iterations))
    assert torch.equal((res.app < 0).int(), x)


@pytest.mark.cuda
def test_bp_decode_kernel_rejects_bad_arguments():
    dev = _card()
    code = get_code("802.11n", "1/2", 27)
    ch = torch.zeros(4, code.N, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        bp_cuda.bp_decode_kernel(torch.zeros(code.N, 4, device=dev).t(),
                                 code.graph, 10, True, 0.7)
    with pytest.raises(ValueError, match="float32"):
        bp_cuda.bp_decode_kernel(ch.double(), code.graph, 10, True, 0.7)
    big = TannerGraph.build(get_protograph("802.16", "1/2", 1000), 1000)
    with pytest.raises(ValueError, match="shared memory"):
        bp_cuda.bp_decode_kernel(torch.zeros(1, big.Nv, device=dev), big, 10,
                                 True, 0.7)


@pytest.mark.cuda
def test_bp_paths_on_the_card():
    """LdpcCode.decode launches K4 once per call on a card (and not with
    bp_kernel=False); the campaign's pipelined loop (pinned copy + event)
    gives the serial loop's records."""
    dev = _card()
    code, x, llr = _bp_inputs(("802.11n", "1/2", 27, "A"), 2.0, 64, dev)
    before = counters()["k4.launches"]
    k = code.decode(llr, 50, "sumprod2")
    assert counters()["k4.launches"] == before + 1
    p = code.decode(llr, 50, "sumprod2", bp_kernel=False)
    assert counters()["k4.launches"] == before + 1
    _bp_gate(k, p, 50)
    params = LdpcParams(standard="802.16", rate="1/2", z=27, ptype="A")
    kw = dict(seed=0, n_measurements=3, min_errors=20, max_blocks=2048,
              batch=128, max_iters=50, device=dev)
    piped = ldpc_waterfall_campaign(params, pipelined=True, **kw)
    serial = ldpc_waterfall_campaign(params, pipelined=False, **kw)
    assert piped == serial and len(piped) == 3


# ---- K2: the signed FWHT as two tensor-core products -------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("E", [1, 2, 192])
@pytest.mark.parametrize("log_w", list(range(8, 21)))
@pytest.mark.parametrize("mode", ["pre", "post", "none"])
def test_fwht_signed_2mm_exact_on_ternary_rows(log_w, mode, E):
    """Every intermediate is an integer of magnitude <= 1024, which bf16
    holds up to 256 and a float32 sum beyond: K2 equals the exact float32
    transform bit for bit, at every width (both kernels, both layouts,
    a = b at the even ones) and with 1, 2 and 192 sign rows."""
    dev = _card()
    w = 1 << log_w
    gen = torch.Generator(device=dev).manual_seed(log_w)
    rows = E * (3 if E <= 2 else 1)
    x = torch.randint(-1, 2, (rows, w), generator=gen, device=dev).float()
    signs = None if mode == "none" else (
        torch.randint(0, 2, (E, w), generator=gen, device=dev) * 2 - 1).float()
    before = counters()["k2.launches"]
    got = wht_cuda.fwht_signed_2mm(x, signs, mode == "pre")
    assert counters()["k2.launches"] == before + 1
    want = wht_cuda.fwht_signed_ref(x, signs, mode == "pre")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("log_w", [12, 13, 14, 15])
def test_fwht_signed_2mm_kernels_agree(log_w):
    """From 2^12 to 2^15 both kernels take the width: the `mma.sync` one and
    the `wgmma` one give the same bits on ternary rows, each named
    explicitly; below, "wgmma" raises, above, "mma"."""
    dev = _card()
    w = 1 << log_w
    gen = torch.Generator(device=dev).manual_seed(log_w)
    x = torch.randint(-1, 2, (5, w), generator=gen, device=dev).float()
    signs = (torch.randint(0, 2, (5, w), generator=gen, device=dev) * 2 - 1).float()
    for pre in (True, False):
        a = wht_cuda.fwht_signed_2mm(x, signs, pre, kernel="mma")
        b = wht_cuda.fwht_signed_2mm(x, signs, pre, kernel="wgmma")
        torch.cuda.synchronize()
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="wgmma"):
        wht_cuda.fwht_signed_2mm(torch.zeros(2, 1 << 11, device=dev), None, True,
                                 kernel="wgmma")
    with pytest.raises(ValueError, match="mma"):
        wht_cuda.fwht_signed_2mm(torch.zeros(2, 1 << 16, device=dev), None, True,
                                 kernel="mma")


@pytest.mark.cuda
@pytest.mark.parametrize("log_w", [8, 11, 15, 17, 19, 20])
@pytest.mark.parametrize("pre", [True, False])
def test_fwht_signed_2mm_matches_plain(log_w, pre):
    dev = _card()
    w = 1 << log_w
    gen = torch.Generator(device=dev).manual_seed(log_w)
    x = torch.randn(4, w, generator=gen, device=dev)
    signs = (torch.randint(0, 2, (2, w), generator=gen, device=dev) * 2 - 1).float()
    got = wht_cuda.fwht_signed_2mm(x, signs, pre)
    want = wht_cuda.fwht_signed_2mm_ref(x, signs, pre)
    torch.cuda.synchronize()
    assert float((got - want).norm()) <= 1e-3 * float(want.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("log_w", list(range(8, 21)))
@pytest.mark.parametrize("mode", ["pre", "post", "none"])
def test_fwht_signed_2mm_float32_operands_match_plain(log_w, mode):
    """K2 with float32 operands, the kernel `k2_layout(log_w, "float32")`
    names (the mma.sync pass kernels below 2^12, the wgmma tile layout to
    2^15, the wgmma wide layout above): bit-equal to the exact transform on
    rows with entries in {-1, 0, 1} (every sum is an integer below 2^24),
    and within 2.5e-6 of the largest entry of its plain version, two
    float32 matmuls at full precision, on Gaussian rows."""
    dev = _card()
    torch.set_float32_matmul_precision("highest")
    w = 1 << log_w
    gen = torch.Generator(device=dev).manual_seed(100 + log_w)
    E = 2
    signs = None if mode == "none" else (
        torch.randint(0, 2, (E, w), generator=gen, device=dev) * 2 - 1).float()
    pre = mode == "pre"
    xt = torch.randint(-1, 2, (2 * E, w), generator=gen, device=dev).float()
    before = counters()["k2.launches"]
    got = wht_cuda.fwht_signed_2mm(xt, signs, pre, mm_dtype="float32")
    assert counters()["k2.launches"] == before + 1
    want = wht_cuda.fwht_signed_ref(xt, signs, pre)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    xg = torch.randn(2 * E, w, generator=gen, device=dev)
    got = wht_cuda.fwht_signed_2mm(xg, signs, pre, mm_dtype="float32")
    want = wht_cuda.fwht_signed_2mm_ref(xg, signs, pre, "float32")
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 2.5e-6 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("log_w", list(range(12, 21)))
def test_fwht_signed_2mm_float32_kernels_agree(log_w):
    """From 2^12 both float32-operand kernels take the width: the wgmma one
    (the table's) and the mma.sync pass kernels give the same bits on
    ternary rows in every sign mode, and each stays within 2.5e-6 of the
    largest entry of the plain version on Gaussian rows."""
    dev = _card()
    torch.set_float32_matmul_precision("highest")
    w = 1 << log_w
    gen = torch.Generator(device=dev).manual_seed(200 + log_w)
    signs = (torch.randint(0, 2, (2, w), generator=gen, device=dev) * 2 - 1).float()
    xt = torch.randint(-1, 2, (4, w), generator=gen, device=dev).float()
    xg = torch.randn(4, w, generator=gen, device=dev)
    for sg, pre in ((signs, True), (signs, False), (None, True)):
        a = wht_cuda.fwht_signed_2mm(xt, sg, pre, "float32", kernel="wgmma")
        b = wht_cuda.fwht_signed_2mm(xt, sg, pre, "float32", kernel="mma")
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        want = wht_cuda.fwht_signed_2mm_ref(xg, sg, pre, "float32")
        for kernel in ("wgmma", "mma"):
            got = wht_cuda.fwht_signed_2mm(xg, sg, pre, "float32", kernel=kernel)
            torch.cuda.synchronize()
            assert float((got - want).abs().max()) <= 2.5e-6 * float(want.abs().max())


@pytest.mark.cuda
def test_fwht_signed_2mm_rejects_bad_arguments():
    """float32 operands launch the mma.sync pass kernels ("mma") at every
    width and the wgmma kernels (None, or "wgmma") from 2^12, and refuse
    "wgmma" below; bad widths and sign planes raise."""
    dev = _card()
    x = torch.zeros(2, 1 << 10, device=dev)
    before = counters()["k2.launches"]
    for kernel in (None, "mma"):
        y = wht_cuda.fwht_signed_2mm(x, None, True, mm_dtype="float32", kernel=kernel)
        assert torch.equal(y, x)
    assert counters()["k2.launches"] == before + 2
    with pytest.raises(ValueError, match="wgmma"):
        wht_cuda.fwht_signed_2mm(x, None, True, mm_dtype="float32", kernel="wgmma")
    for log_w in (12, 16):
        z = torch.zeros(2, 1 << log_w, device=dev)
        y = wht_cuda.fwht_signed_2mm(z, None, True, mm_dtype="float32", kernel="wgmma")
        assert torch.equal(y, z)
    assert counters()["k2.launches"] == before + 4
    with pytest.raises(ValueError):
        wht_cuda.fwht_signed_2mm(torch.zeros(2, 128, device=dev), None, True)
    with pytest.raises(ValueError):
        wht_cuda.fwht_signed_2mm(x, torch.ones(3, 1 << 10, device=dev), True)


@pytest.mark.cuda
def test_sc_decode_through_k2_launch_counts():
    """An SC decode with fwht_mode="2mm" and a full offset-0 window of 2^14
    launches K2 once per design product (2 (t_max - 1) - 1) and K3 once per
    iteration, K1 never; it decodes."""
    _check_sc_decode_launches(M=512, through_k2=True)


@pytest.mark.cuda
def test_2mm_keeps_k1_below_k2_widths():
    """At a window of 2^10 "2mm" keeps the float32 K1, as the JAX package
    keeps its float32 chain below 2^14."""
    _check_sc_decode_launches(M=32, through_k2=False)


def _check_sc_decode_launches(M, through_k2):
    dev = _card()
    params = SparcParams(P=15.0, R=1.0, L=256, M=M, spatially_coupled=True,
                         omega=3, Lambda=8)
    t_max = 12
    design = SparcDesign.for_params(params, 1.0, 5, device=dev)
    assert design.offset == 0 and design.w == 256 * M // 8
    gen = torch.Generator(device=dev).manual_seed(2)
    bits = bitops.random_bits(gen, 4 * params.bit_len).reshape(4, -1)
    beta0 = bitops.bits_to_msg_vector(bits, params.M)
    y = sparc.awgn_channel(design.ab(beta0), 1.0, gen)
    before = counters()
    k1, k2, k3 = (before[f"k{i}.launches"] for i in (1, 2, 3))
    beta, _ = sparc.decode_batch(y, design, params, DecodeParams(t_max=t_max), 1.0,
                                 fwht_mode="2mm")
    products = 2 * (t_max - 1) - 1
    assert counters()["k1.launches"] - k1 == (0 if through_k2 else products)
    assert counters()["k2.launches"] - k2 == (products if through_k2 else 0)
    assert counters()["k3.launches"] - k3 == t_max - 1
    assert torch.equal(beta, beta0)


# ---- the concatenated decode through K1 + K4 -----------------------------------

def _concat_z27(dev, snr, n_trials=8, seed=(3, 0)):
    """(codec, designs, user_bits, ys) of the Monte Carlo's trials at 802.16
    r=1/2 z=27, mults=4, M=2 (L=2592, n=2592; w=2^13, offset 1)."""
    from ldpc_sparc_tpu_torch import ConcatCodec, param_calc
    from ldpc_sparc_tpu_torch.parallel.montecarlo import (concat_mc_designs,
                                                          concat_mc_transmit)
    ldpc = LdpcParams("802.16", "1/2", 27)
    _, _, L, lengths = param_calc(4, 1, ldpc, 0.5, 1.0, get_code("802.16", "1/2", 27).K)
    codec = ConcatCodec(SparcParams(P=19.44, R=1.0, L=L, M=2), ldpc, lengths, True)
    designs = concat_mc_designs(codec, seed, n_trials, device=dev)
    user_bits, ys = concat_mc_transmit(codec, designs, 19.44 / snr, seed)
    return codec, designs, user_bits, ys


@pytest.mark.cuda
@pytest.mark.parametrize("decoder", ["sequential", "naive", "integrated"])
@pytest.mark.parametrize("snr", [3.0, 6.0])
def test_concat_decode_through_k1_k4_matches_plain(decoder, snr):
    """`decode_batch` through K1 + K4 against fwht_kernel=False,
    bp_kernel=False: K4 is bit-equal to the plain decode and K1 differs from
    the plain chain in the order of its adds, so a trial the plain path
    decodes without error decodes without error, and on a trial that does
    not converge the counts differ by at most 1 % of its user bits. The
    kernel path launches K1 once a product and K4 once a BP call; the plain
    path launches neither."""
    dev = _card()
    codec, designs, user_bits, ys = _concat_z27(dev, snr)
    dp = DecodeParams(t_max=25)
    assert (designs.w, designs.offset, designs.D) == (1 << 13, 1, 8)
    reset("k1.launches", "k4.launches", "k3.launches")
    got = codec.decode_batch(ys, designs, dp, decoder)
    torch.cuda.synchronize()
    want_counts = (49, 1) if decoder == "sequential" else (50, 25)
    assert (counters()["k1.launches"], counters()["k4.launches"]) == want_counts
    assert counters()["k3.launches"] == 0
    plain = codec.decode_batch(ys, designs, dp, decoder, fwht_kernel=False,
                               bp_kernel=False)
    torch.cuda.synchronize()
    assert (counters()["k1.launches"], counters()["k4.launches"]) == want_counts
    e_k, e_p = (got != user_bits).sum(-1), (plain != user_bits).sum(-1)
    assert bool((e_k[e_p == 0] == 0).all()), (e_k.tolist(), e_p.tolist())
    assert int((e_k - e_p).abs().max()) <= 0.01 * codec.user_bits_len
    if snr == 6.0 and decoder != "sequential":
        assert int(e_k.sum()) == 0
    # the batch against two of its trials decoded alone
    for t in (0, 5):
        one = codec.build_design(((3, 0), t), dev)
        alone = codec.decode(ys[t], one, dp, decoder)
        e = int((alone != user_bits[t]).sum())
        assert abs(e - int(e_k[t])) <= 0.01 * codec.user_bits_len
        if int(e_k[t]) == 0:
            assert torch.equal(alone, got[t])


@pytest.mark.cuda
def test_concat_monte_carlo_on_the_card():
    """`concat_mc_trial_errors` runs on the card by default, counts what the
    batch decode counts and is a function of (seed, trial) there too."""
    from ldpc_sparc_tpu_torch import concat_mc_trial_errors
    dev = _card()
    codec, designs, user_bits, ys = _concat_z27(dev, 6.0)
    want = (codec.decode_batch(ys, designs, DecodeParams(t_max=25), "integrated")
            != user_bits).sum(-1).cpu().numpy()
    args = (codec.sparc, codec.ldpc_params, codec.lengths, True, DecodeParams(t_max=25),
            19.44 / 6.0, (3, 0))
    got = concat_mc_trial_errors(*args, 8, "integrated")
    assert got.tolist() == want.tolist()
    more = concat_mc_trial_errors(*args, 11, "integrated", n_designs=8)
    assert more[:8].tolist() == got.tolist()


# ---- the kernels against the JAX package at full shapes ------------------------

def _flagship():
    """tests/data/flagship.json and its arrays: two decodes of the JAX
    package, written by tests/data/make_flagship_fixture.py."""
    import json
    from pathlib import Path
    import numpy as np
    data = Path(__file__).resolve().parent / "data"
    meta = json.loads((data / "flagship.json").read_text())
    return meta, lambda name: np.load(data / f"flagship_{name}.npy")


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [None, False])
def test_amp_decode_through_k1_k3_matches_the_jax_fixture(fused):
    """4 codewords at L=1024, M=512 (w = 2^19): the decisions the JAX package
    made on the same y; t_final equal with the plain denoiser tail and within
    1 with K3, whose psi is summed in another order."""
    dev = _card()
    meta, load = _flagship()
    c = meta["amp"]
    params = SparcParams(P=c["P"], R=c["R"], L=c["L"], M=c["M"])
    design = SparcDesign.for_params(params, c["awgn_var"], c["design_seed"], device=dev)
    y = torch.as_tensor(load("amp_y"), device=dev)
    reset("k1.launches", "k3.launches")
    beta, t_final = sparc.decode_batch(y, design, params, DecodeParams(t_max=c["t_max"]),
                                       c["awgn_var"], fused_denoiser=fused)
    torch.cuda.synchronize()
    assert counters()["k1.launches"] == 2 * (c["t_max"] - 1) - 1
    assert counters()["k3.launches"] == (0 if fused is False else c["t_max"] - 1)
    sections = beta.reshape(meta["n_codewords"], c["L"], c["M"]).argmax(-1).cpu()
    assert torch.equal(sections, torch.as_tensor(load("amp_sections")).long())
    want_t = torch.tensor(c["t_final"])
    assert int((t_final.cpu() - want_t).abs().max()) <= (0 if fused is False else 1)


@pytest.mark.cuda
def test_concat_decode_through_k1_k4_matches_the_jax_fixture():
    """4 trials of the z=150 `integrated` point: the user-bit decisions and
    error counts the JAX package made on the same y and designs."""
    import numpy as np
    from ldpc_sparc_tpu_torch import ConcatCodec, param_calc
    dev = _card()
    meta, load = _flagship()
    c, B = meta["concat"], meta["n_codewords"]
    ldpc = LdpcParams(c["standard"], c["rate"], c["z"])
    _, _, L, lengths = param_calc(c["mults"], c["logM"], ldpc, ldpc.rate_float,
                                  c["R_sparc"], get_code(c["standard"], c["rate"], c["z"]).K)
    codec = ConcatCodec(SparcParams(P=c["P"], R=c["R_sparc"], L=L, M=2 ** c["logM"]),
                        ldpc, lengths, True)
    assert (L, codec.n, codec.user_bits_len) == (c["L"], c["n"], c["user_bits_len"])
    designs = codec.build_designs(tuple(c["seed"]), B, dev)
    bits = {k: torch.as_tensor(np.unpackbits(load(k), axis=-1)[:, :codec.user_bits_len]
                               .astype(np.int32), device=dev)
            for k in ("concat_user_bits", "concat_bits_out")}
    reset("k1.launches", "k4.launches")
    got = codec.decode_batch(torch.as_tensor(load("concat_y"), device=dev), designs,
                             DecodeParams(t_max=c["t_max"]), c["decoder"])
    torch.cuda.synchronize()
    assert counters()["k1.launches"] == 2 * c["t_max"]
    assert counters()["k4.launches"] == c["t_max"]
    assert torch.equal(got, bits["concat_bits_out"])
    assert (got != bits["concat_user_bits"]).sum(-1).tolist() == c["errors"]


# ---- complex and K-PSK codes through K1 -----------------------------------------

MOD = dict(P=15.0, R=2.6, L=2048, M=8, modulated=True, K=4, is_complex=True)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["srht", "dft"])
def test_modulated_decode_through_k1_matches_plain(engine):
    """K=4 at L=2048 (n = 3938, w = 2^14, offset 0): with the SRHT engine
    every design product is one K1 launch on stacked real and imaginary rows
    (the encode, then 2 (t_max - 1) - 1 in the decode), with the DFT engine
    none; decisions equal to the plain path's on every codeword that
    converges, and the transmitted message on those."""
    dev = _card()
    params, t_max, B = SparcParams(**MOD), 16, 8
    design = sparc.design_for_params(params, 1.0, 5, engine, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    bits = bitops.random_bits(gen, B * params.bit_len).reshape(B, -1)
    beta0 = bitops.bits_to_msg_vector(bits, params.M, params.K)
    k1, k2 = counters()["k1.launches"], counters()["k2.launches"]
    y = sparc.awgn_channel(design.ab(beta0, fwht_mode="2mm"), 1.0, gen)
    beta_k, t_k = sparc.decode_batch(y, design, params, DecodeParams(t_max=t_max), 1.0,
                                     fwht_mode="2mm")
    torch.cuda.synchronize()
    assert counters()["k1.launches"] - k1 == (2 * (t_max - 1) if engine == "srht" else 0)
    assert counters()["k2.launches"] == k2            # complex data never takes K2
    beta_p, t_p = sparc.decode_batch(y, design, params, DecodeParams(t_max=t_max), 1.0,
                                     fwht_kernel=False)
    conv = t_p < t_max - 1
    assert int(conv.sum()) >= B // 2
    assert torch.equal(beta_k[conv], beta_p[conv]) and torch.equal(t_k[conv], t_p[conv])
    assert torch.equal(beta_k[conv], beta0[conv])
    assert beta_k.dtype == torch.complex64


@pytest.mark.cuda
def test_complex_srht_products_match_plain():
    """One K1 launch a product on 2B real rows, within 1e-5 * max|ref| of
    the plain products, at the offset-0 K=4 shape and an offset-1 one."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    for kw in (MOD, dict(P=15.0, R=1.3, L=48, M=16, is_complex=True)):
        td = SparcDesign.for_params(SparcParams(**kw), 1.0, 5, device=dev)
        beta = torch.complex(torch.randn(3, td.LM, generator=gen, device=dev),
                             torch.randn(3, td.LM, generator=gen, device=dev))
        z = torch.complex(torch.randn(3, td.n, generator=gen, device=dev),
                          torch.randn(3, td.n, generator=gen, device=dev))
        for prod, v in ((td.ab, beta), (td.az, z)):
            before = counters()["k1.launches"]
            got = prod(v)
            assert counters()["k1.launches"] == before + 1
            want = prod(v, fwht_kernel=False)
            torch.cuda.synchronize()
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ---- the Monte Carlos held to the JAX package's committed artifacts -------------

@pytest.mark.cuda
@pytest.mark.parametrize("name,snr", [(n, s) for n, ss in artifacts.K1_SWEEP_ROWS.items()
                                      for s in ss])
def test_sparc_sweep_row_matches_its_artifact(name, snr):
    """`sparc_ber_sweep` at the artifact's configuration and frame count, on
    the card: FER and SER within the two-sample bound of `artifacts`."""
    dev = _card()
    [row] = artifacts.run_sweep_rows(name, [snr], device=dev)
    table = artifacts.compare_sweep(name, [row])
    assert all(c["ok"] for c in table), table


@pytest.mark.cuda
@pytest.mark.parametrize("snr", artifacts.CAMPAIGN_SNRS)
def test_campaign_point_matches_its_artifact(snr):
    """The campaign's per-point counter through K4 under campaign_tpu.json's
    protocol (sim_id 7): BER within tests/test_campaign_artifact.py's bound
    of the artifact's point and of the reference points within 0.1 dB."""
    dev = _card()
    cfg = artifacts.campaign_config(artifacts.CAMPAIGN_SIM_ID)
    before = counters()["k4.launches"]
    rec = artifacts.run_campaign_point(cfg, snr, device=dev)
    assert rec[6] >= cfg["protocol"]["min_errors"]
    assert counters()["k4.launches"] - before == rec[5] // cfg["protocol"]["batch"]
    table = artifacts.compare_campaign_point(cfg, rec)
    assert len(table) >= 2 and all(c["ok"] for c in table), table


@pytest.mark.cuda
@pytest.mark.parametrize("code", artifacts.MINSUM_CODES, ids="-".join)
def test_minsum_points_match_their_artifact(code):
    """minsum_campaign.json at reduced depth: each code's cliff point and its
    point nearest BER 1e-4 through K4 under the artifact's protocol (batch
    512, minsum, corr_factor 0.7, <= 200 iterations, >= 100 block errors),
    the block error rate within the two-sample bound."""
    dev = _card()
    cfg = artifacts.minsum_config(*code)
    for point in artifacts.minsum_held_points(cfg):
        before = counters()["k4.launches"]
        rec = artifacts.run_campaign_point(cfg, point["snr"], device=dev)
        assert counters()["k4.launches"] - before == rec[5] // cfg["protocol"]["batch"]
        got = artifacts.compare_minsum_point(cfg, rec)
        assert got["ok"], got


@pytest.mark.cuda
def test_semi_protected_floor_matches_its_artifact():
    """concat_sweep_semi.jsonl at reduced depth: the sequential decoder's
    floor (linear SNR 6.0, 25 runs) at percent_protected 0.9 and 0.8,
    through K1 + K4, each within the bound of `artifacts.compare_semi_row`,
    which is within 0.012 there; 0.8's above 0.9's."""
    from ldpc_sparc_tpu_torch import param_calc_semi_protected
    from ldpc_sparc_tpu_torch.parallel.montecarlo import concat_ber_point
    dev = _card()
    ldpc = LdpcParams(standard="802.11n", rate="5/6", z=81)
    floor, got = artifacts.SEMI_SNRS[1], {}
    for pp in (0.9, 0.8):
        cfg, h, rows = artifacts.semi_configs()[pp]
        _, R_ldpc, L_ldpc, lengths, _ = param_calc_semi_protected(
            0.8, 3, pp, 64, ldpc, ldpc.rate_float, get_code("802.11n", "5/6", 81).K)
        sp = SparcParams(P=19.44, R=R_ldpc, L=L_ldpc, M=64)
        row = concat_ber_point(sp, ldpc, lengths, True, DecodeParams(t_max=25),
                               19.44 / floor, (0, 0), 25, "sequential", device=dev)
        got[pp] = artifacts.compare_semi_row(
            row, rows[artifacts.semi_row_key(h, "sequential", floor)], 6)
        assert got[pp]["ok"] and got[pp]["bound"] <= artifacts.SEMI_FLOOR_BOUND, got
    assert got[0.9]["port"] < got[0.8]["port"]


def _oracle_llrs(code, n, snr_db=2.0, seed=0):
    """tests/test_ldpc.py's protocol: per codeword its bits, then its noise,
    from one numpy generator; float64 LLRs."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sigma2 = 1.0 / 10 ** (snr_db / 10)
    rows = []
    for _ in range(n):
        x = code.encode(torch.as_tensor(rng.integers(0, 2, code.K))).numpy()
        rows.append(2.0 / sigma2 * ((1.0 - 2.0 * x) + rng.normal(0, sigma2 ** 0.5, code.N)))
    return np.stack(rows)


@pytest.mark.cuda
@pytest.mark.parametrize("dectype", ["sumprod", "sumprod2", "minsum"])
def test_bp_decode_kernel_matches_the_ports_oracle(dectype):
    """K4 through `LdpcCode.decode` against the port's float64 C++ oracle
    (`decode_ref`): iterations and decisions equal on every codeword."""
    import numpy as np
    dev = _card()
    code = get_code("802.11n", "1/2", 27)
    llr = _oracle_llrs(code, 32)
    before = counters()["k4.launches"]
    res = code.decode(torch.as_tensor(llr, dtype=torch.float32, device=dev), 60, dectype)
    assert counters()["k4.launches"] - before == 1
    its, dec = res.iterations.cpu().numpy(), (res.app < 0).cpu().numpy()
    for i, row in enumerate(llr):
        app, it = code.decode_ref(row, 60, dectype)
        assert its[i] == it, i
        np.testing.assert_array_equal(dec[i], app < 0)


@pytest.mark.cuda
def test_ldpc_campaign_cli_resumes_on_the_card(tmp_path):
    """`ldpc-campaign` through K4: a store cut after its first point and
    rerun gives the uninterrupted run's records and files."""
    from ldpc_sparc_tpu_torch import cli
    _card()
    argv = ["ldpc-campaign", "--sim-id", "7", "--points", "3", "--batch", "64",
            "--max-iters", "50", "--min-errors", "10", "--device", "cuda"]
    recs = cli.main(argv + ["--out", str(tmp_path / "a")])
    lines = (tmp_path / "a" / "ldpc_campaign.jsonl").read_text().splitlines(keepends=True)
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "ldpc_campaign.jsonl").write_text(lines[0])
    before = counters()["k4.launches"]
    assert cli.main(argv + ["--out", str(tmp_path / "b")]) == recs
    # each point's batches and the speculative one the pipelined loop discards
    assert (counters()["k4.launches"] - before
            == sum(r[5] for r in recs[1:]) // 64 + len(recs[1:]))
    for name in ("ldpc_campaign.jsonl", "results.txt", "results.csv"):
        assert (tmp_path / "a" / name).read_text() == (tmp_path / "b" / name).read_text()


SC_SMALL = dict(P=15.0, R=1.2, L=64, M=32, spatially_coupled=True, omega=2, Lambda=8)


def _sharded_counts_on_card(dp, sec):
    """A rank's counters of the sharded step on SC_SMALL (spawned by
    `run_ranks`)."""
    from ldpc_sparc_tpu_torch.parallel.mesh import make_mesh
    from ldpc_sparc_tpu_torch.parallel.sharded import make_sharded_sim_step
    mesh = make_mesh(dp, sec, device="cuda")
    step, _ = make_sharded_sim_step(SparcParams(**SC_SMALL), DecodeParams(t_max=20), 1.0,
                                    mesh, seed=3)
    before = (counters()["k1.launches"], counters()["k3.launches"])
    out = step([(3, t) for t in range(8)])
    after = counters()
    return out, (after["k1.launches"] - before[0], after["k3.launches"] - before[1])


@pytest.mark.cuda
def test_mesh_of_one_on_the_card():
    """A world of one (NCCL, no launcher): the Monte Carlos equal mesh=None,
    and the sharded decode(y) equals `decode_batch` through K1 + K3."""
    import numpy as np
    import torch.distributed as dist
    from ldpc_sparc_tpu_torch import concat_mc_trial_errors, param_calc
    from ldpc_sparc_tpu_torch.parallel.mesh import make_mesh
    from ldpc_sparc_tpu_torch.parallel.montecarlo import sparc_mc_counts
    from ldpc_sparc_tpu_torch.parallel.sharded import make_sharded_sim_step
    dev = _card()
    mesh = make_mesh()
    try:
        p, dec = SparcParams(P=15.0, R=1.0, L=64, M=512), DecodeParams(t_max=12)
        assert sparc_mc_counts(p, dec, 1.0, 2, 6, mesh=mesh) == \
            sparc_mc_counts(p, dec, 1.0, 2, 6, device=dev)
        ldpc = LdpcParams(standard="802.16", rate="1/2", z=12)
        _, _, L, lengths = param_calc(2, 2, ldpc, 0.5, 1.0, get_code("802.16", "1/2", 12).K)
        args = (SparcParams(P=19.44, R=1.0, L=L, M=4), ldpc, lengths, True,
                DecodeParams(t_max=8), 19.44 / 6.0, 2, 6, "integrated")
        np.testing.assert_array_equal(concat_mc_trial_errors(*args, mesh=mesh),
                                      concat_mc_trial_errors(*args, device=dev))
        sc, dsc = SparcParams(**SC_SMALL), DecodeParams(t_max=20)
        design = SparcDesign.for_params(sc, 1.0, 3, device=dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        beta0 = bitops.bits_to_msg_vector(bitops.random_bits(gen, 8 * sc.bit_len)
                                          .reshape(8, -1), sc.M)
        y = design.ab(beta0) + torch.randn(8, design.n, generator=gen, device=dev)
        step, _ = make_sharded_sim_step(sc, dsc, 1.0, mesh, seed=3)
        before = (counters()["k1.launches"], counters()["k3.launches"])
        bs, ts = step.decode(y)
        after = counters()
        assert after["k1.launches"] > before[0] and after["k3.launches"] > before[1]
        bu, tu = sparc.decode_batch(y, design, sc, dsc, 1.0)
        conv = tu < 19
        assert int(conv.sum()) >= 4
        assert torch.equal(bs[conv], bu[conv]) and int((ts - tu).abs().max()) <= 1
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_sharded_step_on_two_ranks_of_one_card():
    """The section-sharded step at (1,2), two ranks on the one card through
    gloo, gives the counters of (1,1)."""
    from ldpc_sparc_tpu_torch.parallel.mesh import run_ranks
    _card()
    [(one, l1)] = run_ranks(_sharded_counts_on_card, 1, 1, 1, backend="nccl", timeout=300)
    two = run_ranks(_sharded_counts_on_card, 2, 1, 2, backend="gloo", timeout=300)
    assert two[0][0] == two[1][0] == one, (one, two)
    assert min(l1) > 0 and min(two[0][1]) > 0
