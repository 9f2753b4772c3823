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
bound of 1e-3 of its plain version on Gaussian rows; the
denoiser tail uses tests/test_denoiser_pallas.py's tolerances (s to rtol
1e-6, the softmax and energies to rtol 1e-5, since exp and the sums
reassociate). The BP decode must give the plain decode's iteration counts
on every codeword, and its decisions and APP (rtol 1e-5, atol 1e-4, the
bound tests/test_bp_pallas.py holds the TPU kernel to) on every codeword
that stopped by parity.
"""

import pytest
import torch

from ldpc_sparc_tpu_torch import (DecodeParams, LdpcParams, SparcDesign,
                                  SparcParams, get_code,
                                  ldpc_waterfall_campaign)
from ldpc_sparc_tpu_torch.models import sparc
from ldpc_sparc_tpu_torch.models.ldpc_tables import get_protograph
from ldpc_sparc_tpu_torch.ops import bp_cuda, denoiser_cuda, wht_cuda
from ldpc_sparc_tpu_torch.ops.bp import TannerGraph
from ldpc_sparc_tpu_torch.utils import bits as bitops


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
    before = wht_cuda.LAUNCHES
    got = wht_cuda.fwht_signed(x, signs, mode == "pre")
    assert wht_cuda.LAUNCHES == before + 1
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
            before = wht_cuda.LAUNCHES
            got = wht_cuda.fwht_signed(x, signs, mode == "pre", route=route)
            assert wht_cuda.LAUNCHES == before + 1
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
                before = wht_cuda.LAUNCHES
                got_s = wht_cuda.srht_scatter_fwht(vals, ix, sg, 1 << log_w,
                                                   apply_pre=apply_pre)
                got_g = wht_cuda.srht_fwht_gather(x, sg, ix, apply_pre=apply_pre)
                assert wht_cuda.LAUNCHES == before + 2
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
    k1, k3 = wht_cuda.LAUNCHES, denoiser_cuda.LAUNCHES
    beta_k, t_k = sparc.decode_batch(y, design, params, decode, 1.0)
    assert wht_cuda.LAUNCHES - k1 == 2 * (t_max - 1) - 1
    assert denoiser_cuda.LAUNCHES - k3 == t_max - 1
    beta_p, t_p = sparc.decode_batch(y, design, params, decode, 1.0,
                                     fused_denoiser=False, fwht_kernel=False)
    assert torch.equal(beta_k, beta_p) and torch.equal(t_k, t_p)
    assert torch.equal(bitops.msg_vector_to_bits(beta_k, params.M), bits)


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
    before = bp_cuda.LAUNCHES
    got = bp_cuda.bp_decode_kernel(llr, code.graph, BP_ITERS, correction, 0.7,
                                   variant=variant)
    assert bp_cuda.LAUNCHES == before + 1
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
    before = bp_cuda.LAUNCHES
    k = code.decode(llr, 50, "sumprod2")
    assert bp_cuda.LAUNCHES == before + 1
    p = code.decode(llr, 50, "sumprod2", bp_kernel=False)
    assert bp_cuda.LAUNCHES == before + 1
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
    before = wht_cuda.LAUNCHES_2MM
    got = wht_cuda.fwht_signed_2mm(x, signs, mode == "pre")
    assert wht_cuda.LAUNCHES_2MM == before + 1
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
def test_fwht_signed_2mm_rejects_bad_arguments():
    dev = _card()
    x = torch.zeros(2, 1 << 10, device=dev)
    with pytest.raises(NotImplementedError):
        wht_cuda.fwht_signed_2mm(x, None, True, mm_dtype="float32")
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
    k1, k2, k3 = wht_cuda.LAUNCHES, wht_cuda.LAUNCHES_2MM, denoiser_cuda.LAUNCHES
    beta, _ = sparc.decode_batch(y, design, params, DecodeParams(t_max=t_max), 1.0,
                                 fwht_mode="2mm")
    products = 2 * (t_max - 1) - 1
    assert wht_cuda.LAUNCHES - k1 == (0 if through_k2 else products)
    assert wht_cuda.LAUNCHES_2MM - k2 == (products if through_k2 else 0)
    assert denoiser_cuda.LAUNCHES - k3 == t_max - 1
    assert torch.equal(beta, beta0)
