#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from `ldpc_sparc_tpu_torch/csrc/`,
checks each against its plain PyTorch version on the card (K1, the signed
FWHT, at a width of each of its routes and through its two fused SRHT
products), and drives and times the paths `bench.py` times:

  * slice A, the main path: a plain SPARC AMP decode at L=1024, M=512,
    R=1.0, P=15, awgn_var 1, t_max 25, 256 codewords (phases 2-5);
  * slice B: the LDPC BP decode of 256 codewords of 802.11n r=1/2 z=27 at
    sigma^2 = 10^-0.2, sumprod2, at most 50 iterations (phases 6-7; K4's two
    variants are held bit-equal to each other and timed side by side), and
    the waterfall campaign's 16-point segment, 802.16 r=1/2 z=27, seed 7,
    batch 512, sumprod2, at most 200 iterations (phase 8).
  * slice C: the spatially coupled SPARC decode of the reference's large
    SC configuration (L=2048, M=512, omega=6, Lambda=32, R=1.5, P=15,
    awgn_var 1, t_max 40, 64 codewords; E=192 design blocks of width 2^15)
    through K1+K3, K2+K3 and the plain path (phases 9-10; K2 bit for bit on
    ternary rows at a width of each of its kernels and layouts), and the
    `sparc-sweep` entry point on it through K2, resumed from its store
    (phase 11).

Each phase prints one line. The line before the last is a JSON
summary of the kernels, each with its time, its plain version's, the least
time the card could take for the same bytes and operations (`bound_ms`,
against the peaks below) and, where one library call computes the same
function, that call's; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failure raises, exits non-zero and prints no such line. Without a CUDA
device it exits non-zero at once.
"""

import json
import subprocess
import sys
import time

# the main path: bench.py's headline configuration
L, M, R, P = 1024, 512, 1.0, 15.0
AWGN_VAR, T_MAX, BATCH, SEED = 1.0, 25, 256, 0
# kernel vs plain FWHT: both float32; log2(w) <= 22 stages of float32
# rounding give relative errors near 1e-6 of the largest entry, so
# 1e-5 * max|ref| is a bound a wrong butterfly or sign cannot meet
FWHT_REL_BOUND = 1e-5
# K1's routes and the log2 widths phase 2 checks each at
K1_ROUTE_WIDTHS = (("block", (10, 14, 15)), ("cluster", (16, 17, 18, 19)),
                   ("two_pass", (20,)))
# the index side of the two design products: (rows, E, k, log2 w)
HEADLINE_SRHT = (BATCH, 1, 9216, 19)
SC_SRHT = (64 * 192, 192, 332, 15)
# the card's peaks, for each kernel's bound: NVIDIA's H100 SXM data sheet
# (device memory, float32 outside the tensor cores, dense bf16)
HBM_BYTES_PER_S, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
# kernel vs plain denoiser tail: tests/test_denoiser_pallas.py's tolerances
# (s is bit-equal by construction; exp and the sums reassociate)
DENOISE_TOL = {"s": (1e-6, 1e-6), "beta_new": (1e-5, 1e-7),
               "sec_en": (1e-5, 1e-7)}

# slice B: bench.py's LDPC BP decode and campaign segment
BP_CODE, BP_BATCH, BP_ITERS, BP_SNR_DB = ("802.11n", "1/2", 27, "A"), 256, 50, 2.0
CAMPAIGN_CODE = ("802.16", "1/2", 27, "A")
CAMPAIGN = dict(seed=7, batch=512, dectype="sumprod2", max_iters=200)
CAMPAIGN_WARM, CAMPAIGN_POINTS = 2, 16
PLAIN_CAMPAIGN_POINTS = 2   # the plain path's cut: its full segment takes minutes
# K4 vs plain BP (code, method, SNR dB, batch, max_iters): the largest check
# degree, the largest z, the largest shared state, and the campaign's shape.
# Iterations must be equal on every codeword; decisions equal and the APP
# within tests/test_bp_pallas.py's rtol 1e-5 / atol 1e-4 on every codeword
# that stopped by parity (one that runs to the cap may drift apart at
# float32 rounding). In the seed-0 draws 18 and 22 of 256 codewords run to
# the cap in the two 802.11n cases, 1 in each 802.16 z=150 case and none
# of 512 at the campaign's shape.
K4_CASES = [(("802.11n", "1/2", 27, "A"), "sumprod", 1.5, BP_BATCH, BP_ITERS),
            (("802.11n", "5/6", 81, "A"), "minsum", 5.5, BP_BATCH, BP_ITERS),
            (("802.16", "1/2", 150, "A"), "sumprod", 1.5, BP_BATCH, BP_ITERS),
            (("802.16", "3/4", 150, "B"), "sumprod", 4.5, BP_BATCH, BP_ITERS),
            (CAMPAIGN_CODE, CAMPAIGN["dectype"], 2.5, CAMPAIGN["batch"],
             CAMPAIGN["max_iters"])]
BP_TOL = (1e-5, 1e-4)
# further draws of the BP path's inputs whose K4 time phase 7 reports beside
# seed 0's: the decode lasts as long as its slowest codeword; seed 0's
# stops after 29 iterations, and seeds 1-5 each hold one or two codewords
# that run to the cap
BP_DRAW_SEEDS = (0, 1, 2, 3, 4, 5)

# slice C: the reference's large SC decode (examples/sc_decode_wave.py:50-52,
# benchmarks/reproduce_baselines.py:92-95)
SC = dict(P=15.0, R=1.5, L=2048, M=512, spatially_coupled=True, omega=6, Lambda=32)
SC_AWGN, SC_T_MAX, SC_BATCH, SC_REPS = 1.0, 40, 64, 3
# K2 against its plain version on Gaussian rows: both round X and T to bf16,
# but the float32 sums of T run in another order, so a T entry near a bf16
# rounding boundary can round the other way: one bf16 ulp (2^-8 of that
# entry) on about 2^-10 of the entries, a relative Frobenius error near
# 1e-4 at 2^19. A wrong Hadamard sign or index moves it past 5e-3 (one bad
# entry of H_256 alone gives 8e-3), so 1e-3 separates the two.
K2_REL_BOUND = 1e-3
# widths phase 9 holds K2 bit for bit on ternary rows: the mma.sync kernel
# (2^8), the wgmma tile kernel (2^12, 2^15), the wide layout (2^16, a = b;
# 2^19, the headline's; 2^20, a = b = 1024)
K2_TERNARY_LOG_W = (8, 12, 15, 16, 19, 20)
# K2 against the float32 K1: the JAX package's bf16 bound,
# max|d| / mean|ref| <= 0.04 (benchmarks/fwht_pallas_check.py:154-157)
K2_F32_BOUND = 0.04
# phase 11: sparc-sweep on the SC code, SNR 10, 15, 20 (awgn_var 1.5, 1, 0.75)
SWEEP_TRIALS = 16
SWEEP_FLAGS = ["--P", "15", "--R", "1.5", "--L", "2048", "--M", "512",
               "--spatially-coupled", "--omega", "6", "--Lambda", "32",
               "--t-max", str(SC_T_MAX), "--trials", str(SWEEP_TRIALS), "--num-snrs", "3",
               "--snr-start", "10", "--snr-stop", "20", "--fwht-mode", "2mm",
               "--device", "cuda"]


def phase(n, text):
    print(f"phase {n} {text}", flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds of fn() on the card, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def fwht_err(got, want):
    """(max |got - want|, bound) for the FWHT comparisons."""
    return float((got - want).abs().max()), FWHT_REL_BOUND * float(want.abs().max())


def least_ms(n_bytes, n_ops, ops_per_s=F32_FLOPS):
    """{"bound_ms", "bound_by"}: the larger of bytes over the memory rate and
    operations over their peak rate."""
    by_bytes, by_ops = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * n_ops / ops_per_s
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def srht_inputs(shape, gen, dev):
    """(idx int32 (E, k) sorted without repeats, signs (E, w)) for a fused
    SRHT product check at shape = (rows, E, k, log2 w)."""
    import torch
    _, E, k, log_w = shape
    w = 1 << log_w
    idx = torch.stack([torch.randperm(w, generator=gen, device=dev)[:k].sort().values
                       for _ in range(E)]).to(torch.int32)
    signs = (torch.randint(0, 2, (E, w), generator=gen, device=dev) * 2 - 1).float()
    return idx, signs


def check_fused_srht(shape, idx, signs, gen, dev):
    """srht_scatter_fwht and srht_fwht_gather against their plain versions at
    shape = (rows, E, k, log2 w): bit for bit on ternary rows, within
    FWHT_REL_BOUND on Gaussian rows. Returns (text, largest Gaussian error)."""
    import torch
    from ldpc_sparc_tpu_torch.ops import wht_cuda
    rows, E, k, log_w = shape
    w = 1 << log_w
    worst, parts = 0.0, []
    for kind in ("ternary", "gaussian"):
        if kind == "ternary":
            vals = torch.randint(-1, 2, (rows, k), generator=gen, device=dev).float()
            x = torch.randint(-1, 2, (rows, w), generator=gen, device=dev).float()
        else:
            vals = torch.randn(rows, k, generator=gen, device=dev)
            x = torch.randn(rows, w, generator=gen, device=dev)
        for name, got, want in (
                ("scatter", lambda: wht_cuda.srht_scatter_fwht(vals, idx, signs, w),
                 lambda: wht_cuda.srht_scatter_fwht_ref(vals, idx, signs, w)),
                ("gather", lambda: wht_cuda.srht_fwht_gather(x, signs, idx),
                 lambda: wht_cuda.srht_fwht_gather_ref(x, signs, idx))):
            g, r = got(), want()
            torch.cuda.synchronize()
            err, lim = fwht_err(g, r)
            if kind == "ternary" and not torch.equal(g, r):
                raise AssertionError(f"srht {name} at {shape} is not bit-equal to "
                                     f"its plain version on ternary rows")
            if not err <= lim:
                raise AssertionError(f"srht {name} at {shape}: {err} > {lim}")
            if kind == "gaussian":
                worst = max(worst, err)
                parts.append(f"{name} {err:.2e}")
            del g, r
    return (f"({rows} rows, idx ({E}, {k}), 2^{log_w}) ternary bit-equal, Gaussian "
            + " ".join(parts)), worst


def time_k1(shape, idx, signs, routes, gen, dev):
    """Times of K1 at shape = (rows, E, k, log2 w): `fwht_signed` by each of
    `routes` (pre, post), and the two fused products with their plain
    versions. Returns {name: ms}."""
    import torch
    from ldpc_sparc_tpu_torch.ops import wht_cuda
    rows, E, k, log_w = shape
    w = 1 << log_w
    x = torch.randn(rows, w, generator=gen, device=dev)
    vals = torch.randn(rows, k, generator=gen, device=dev)
    t = {}
    for route in routes:
        for pre in (True, False):
            t[f"{route} {'pre' if pre else 'post'}"] = cuda_ms(
                lambda: wht_cuda.fwht_signed(x, signs, pre, route=route))
    t["scatter"] = cuda_ms(lambda: wht_cuda.srht_scatter_fwht(vals, idx, signs, w,
                                                              validate=False))
    t["gather"] = cuda_ms(lambda: wht_cuda.srht_fwht_gather(x, signs, idx,
                                                            validate=False))
    t["scatter plain"] = cuda_ms(
        lambda: wht_cuda.srht_scatter_fwht_ref(vals, idx, signs, w), reps=5)
    t["gather plain"] = cuda_ms(
        lambda: wht_cuda.srht_fwht_gather_ref(x, signs, idx), reps=5)
    return t


def bp_inputs(code, snr_db, batch, seed, dev):
    """(codewords, LLRs) of `batch` random codewords, BPSK over AWGN at
    sigma^2 = 10^(-snr_db/10), made on the CPU from `seed` (so a CPU run
    reproduces them) and moved to `dev`."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    x = code.encode(torch.randint(0, 2, (batch, code.K), generator=gen))
    sigma2 = 10 ** (-snr_db / 10)
    y = (1 - 2 * x.float()) + sigma2 ** 0.5 * torch.randn(batch, code.N,
                                                          generator=gen)
    return x.to(dev), (2 / sigma2 * y).to(dev)


def bp_compare(got, want, max_iters):
    """The K4 gate (see K4_CASES). Returns (max |d app| over the codewords
    that stopped by parity, number that ran to the cap)."""
    import torch
    if not torch.equal(got.iterations, want.iterations):
        n = int((got.iterations != want.iterations).sum())
        raise AssertionError(f"iterations differ on {n} codewords")
    stopped = want.iterations < max_iters
    if not torch.equal(got.app[stopped] < 0, want.app[stopped] < 0):
        raise AssertionError("decisions differ on a codeword that stopped")
    torch.testing.assert_close(got.app[stopped], want.app[stopped],
                               rtol=BP_TOL[0], atol=BP_TOL[1])
    err = float((got.app[stopped] - want.app[stopped]).abs().max()) \
        if bool(stopped.any()) else 0.0
    return err, int((~stopped).sum())


def slice_b(dev, card):
    """Phases 6-8; returns K4's entry of the kernels line."""
    import torch
    from ldpc_sparc_tpu_torch import LdpcParams, get_code, ldpc_waterfall_campaign
    from ldpc_sparc_tpu_torch.ops import bp_cuda

    # -- 6: K4 against its plain version ----------------------------------------
    k4_err, parts = 0.0, []
    for cfg, method, snr, batch, iters in K4_CASES:
        code = get_code(*cfg)
        _, llr = bp_inputs(code, snr, batch, SEED, dev)
        corr = method != "minsum"
        got = bp_cuda.bp_decode_kernel(llr, code.graph, iters, corr, 0.7)
        want = bp_cuda.bp_decode_ref(llr, code.graph, iters, corr, 0.7)
        torch.cuda.synchronize()
        err, capped = bp_compare(got, want, iters)
        k4_err = max(k4_err, err)
        by_variant = {v: bp_cuda.bp_decode_kernel(llr, code.graph, iters, corr, 0.7,
                                                  variant=v) for v in bp_cuda.VARIANTS}
        torch.cuda.synchronize()
        for v, res_v in by_variant.items():
            if not (torch.equal(res_v.iterations, got.iterations)
                    and torch.equal(res_v.app, got.app)):
                raise AssertionError(f"K4 variant {v!r} is not bit-equal to the table's "
                                     f"({bp_cuda.k4_variant(code.graph)!r}) on {cfg}")
        parts.append(f"{cfg[0]} r{cfg[1]}{cfg[3] if cfg[3] != 'A' else ''} z={cfg[2]} "
                     f"{method} {snr:g} dB batch {batch} <= {iters} iterations "
                     f"({bp_cuda.k4_variant(code.graph)}, "
                     f"{bp_cuda.shared_bytes(code.graph)} B shared): max|d app| "
                     f"{err:.2e}, iterations mean/max "
                     f"{float(got.iterations.float().mean()):.2f}/"
                     f"{int(got.iterations.max())}, {capped} at the cap")
    phase(6, f"bp_decode_kernel vs plain (iterations equal on all; decisions and "
             f"app rtol {BP_TOL[0]:g} atol {BP_TOL[1]:g} on those stopped by "
             f"parity), and its variants {bp_cuda.VARIANTS} torch.equal in iterations "
             f"and app on every codeword: " + "; ".join(parts))

    # -- 7: the BP path (bench.py's ldpc_bp_ms_per_block) ------------------------
    code = get_code(*BP_CODE)
    x, llr = bp_inputs(code, BP_SNR_DB, BP_BATCH, SEED, dev)
    bp_cuda.LAUNCHES = 0
    res = code.decode(llr, BP_ITERS, "sumprod2")
    torch.cuda.synchronize()
    launches = bp_cuda.LAUNCHES
    bit_errs = int(((res.app < 0).int() != x).sum())
    if bit_errs != 0:
        raise AssertionError(f"BP path: {bit_errs} bit errors")
    if launches != 1:
        raise AssertionError(f"BP path: bp_decode_kernel launched {launches} times")
    if res.app.shape != (BP_BATCH, code.N) or not bool(torch.isfinite(res.app).all()):
        raise AssertionError("BP path output has the wrong shape or is not finite")
    plain = code.decode(llr, BP_ITERS, "sumprod2", bp_kernel=False)
    torch.cuda.synchronize()
    err, capped = bp_compare(res, plain, BP_ITERS)
    k4_err = max(k4_err, err)

    def bp_window(kernel):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            code.decode(llr, BP_ITERS, "sumprod2", bp_kernel=kernel)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / 5

    best = {True: float("inf"), False: float("inf")}
    for i in range(4):   # alternate: kernel, plain, plain, kernel, ...
        for kernel in ((True, False) if i % 2 == 0 else (False, True)):
            best[kernel] = min(best[kernel], bp_window(kernel))
    ms_block = {k: v / BP_BATCH * 1e3 for k, v in best.items()}
    k4_ms = cuda_ms(lambda: bp_cuda.bp_decode_kernel(llr, code.graph, BP_ITERS,
                                                     True, 0.7))
    k4_plain_ms = cuda_ms(lambda: bp_cuda.bp_decode_ref(llr, code.graph, BP_ITERS,
                                                        True, 0.7), reps=5)
    # K4's bound from what this draw needs. A codeword that stops after `it`
    # iterations runs min(it + 1, cap) check phases; a check of degree d
    # takes 3 d - 5 Lxor evaluations (d - 2 forward prefixes, d - 1 backward
    # suffixes, d - 2 extrinsic outputs), each counted as 14 float32
    # operations (sign, two abs, min, a + b, a - b, two abs, two exp, two
    # log1p, two adds); a variable phase takes 2 adds an edge. It reads the
    # LLRs and writes the APPs and the iteration counts. The slowest
    # codeword's dependent chain is its phases times the 2 d_max - 3 Lxors
    # that follow one another in the largest check.
    deg = (code.graph.chk_edges >= 0).sum(1)
    phases = torch.clamp(res.iterations.long() + 1, max=BP_ITERS)
    n_lxor = int(phases.sum()) * code.graph.z * int((3 * deg - 5).sum())
    k4_ops = 14 * n_lxor + 2 * code.graph.E * code.graph.z * int(phases.sum())
    k4_bound = least_ms(4 * (2 * BP_BATCH * code.N + BP_BATCH), k4_ops)
    chain = int(phases.max()) * (2 * int(deg.max()) - 3)
    # the second bound: that chain at the latency of one dependent Lxor,
    # which the timing kernel of csrc/bp_decode.cu measures on one warp
    lo, hi = 20_000, 120_000
    lxor_us = 1e3 * (min(bp_cuda.lxor_chain_ms(hi) for _ in range(3))
                     - min(bp_cuda.lxor_chain_ms(lo) for _ in range(3))) / (hi - lo)
    chain_ms = chain * lxor_us / 1e3
    draws = []
    for s in BP_DRAW_SEEDS:
        _, llr_s = bp_inputs(code, BP_SNR_DB, BP_BATCH, s, dev)
        slowest = int(bp_cuda.bp_decode_kernel(llr_s, code.graph, BP_ITERS, True,
                                               0.7).iterations.max())
        ms = {v: cuda_ms(lambda: bp_cuda.bp_decode_kernel(
            llr_s, code.graph, BP_ITERS, True, 0.7, variant=v))
            for v in bp_cuda.VARIANTS}
        draws.append(f"seed {s} slowest {slowest} it "
                     + " / ".join(f"{v} {t:.4f} ms" for v, t in ms.items())
                     + f" ({ms[bp_cuda.k4_variant(code.graph)] / BP_BATCH:.6f} ms/block)")
    phase(7,f"BP path {BP_CODE[0]} r={BP_CODE[1]} z={BP_CODE[2]} batch {BP_BATCH} "
             f"sumprod2 <= {BP_ITERS} iterations at sigma^2 = 10^-{BP_SNR_DB / 10:g} on "
             f"{card}: bit errors {bit_errs} | K4 launches {launches} | iterations "
             f"mean/max {float(res.iterations.float().mean()):.2f}/"
             f"{int(res.iterations.max())} | kernel and plain paths agree "
             f"(max|d app| {err:.2e}) | ldpc_bp_ms_per_block kernel path "
             f"{ms_block[True]:.6f} (best decode {best[True] * 1e3:.4f} ms), plain "
             f"path {ms_block[False]:.6f} (best decode {best[False] * 1e3:.4f} ms) | "
             f"bp_decode_kernel {k4_ms:.4f} ms (plain {k4_plain_ms:.4f} ms; bound "
             f"{k4_bound['bound_ms']:.6f} ms by {k4_bound['bound_by']}: {n_lxor} Lxor "
             f"evaluations, {k4_ops} operations; second bound {chain_ms:.4f} ms: the "
             f"slowest codeword's chain of {chain} Lxors at {lxor_us:.4f} us a "
             f"dependent Lxor, against {1e3 * k4_ms / chain:.3f} us each in the "
             f"decode) | bp_decode_kernel across draws, variants "
             f"{' / '.join(bp_cuda.VARIANTS)} (the table takes "
             f"{bp_cuda.k4_variant(code.graph)}): " + ", ".join(draws))

    # -- 8: the campaign segment (bench.py's campaign_blocks_per_s) --------------
    params = LdpcParams(*CAMPAIGN_CODE)
    K = get_code(*CAMPAIGN_CODE).K

    def campaign(n, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        recs = ldpc_waterfall_campaign(params, n_measurements=n, device=dev,
                                       **CAMPAIGN, **kw)
        torch.cuda.synchronize()
        return recs, time.perf_counter() - t

    campaign(CAMPAIGN_WARM)
    bp_cuda.LAUNCHES = 0
    recs, dt = campaign(CAMPAIGN_POINTS)
    launches_c = bp_cuda.LAUNCHES
    blocks = sum(r[5] for r in recs)
    if len(recs) != CAMPAIGN_POINTS or any(
            len(r) != 10 or r[7] != r[5] * K or not 0 <= r[6] <= r[5] for r in recs):
        raise AssertionError(f"campaign records are malformed: {recs}")
    if not all(b[4] > a[4] for a, b in zip(recs, recs[1:])):
        raise AssertionError("campaign SNR does not step up")
    if not recs[-1][6] / recs[-1][5] < recs[0][6] / recs[0][5]:
        raise AssertionError("campaign block-error rate does not fall with SNR")
    if launches_c < blocks // CAMPAIGN["batch"]:
        raise AssertionError(f"campaign launched K4 {launches_c} times for "
                             f"{blocks // CAMPAIGN['batch']} batches")
    cut_k, dt_k = campaign(PLAIN_CAMPAIGN_POINTS)
    cut_p, dt_p = campaign(PLAIN_CAMPAIGN_POINTS, bp_kernel=False)
    if cut_k != cut_p:
        raise AssertionError(f"campaign records differ between the kernel and "
                             f"plain paths: {cut_k} vs {cut_p}")
    cut_blocks = sum(r[5] for r in cut_k)
    phase(8, f"campaign {CAMPAIGN_CODE[0]} r={CAMPAIGN_CODE[1]} z={CAMPAIGN_CODE[2]} "
             f"seed {CAMPAIGN['seed']} batch {CAMPAIGN['batch']} sumprod2 <= "
             f"{CAMPAIGN['max_iters']} iterations on {card}: {CAMPAIGN_POINTS}-point "
             f"segment after a {CAMPAIGN_WARM}-point warm-up, {blocks} blocks in "
             f"{dt:.4f} s, SNR {recs[0][4]:.3f} -> {recs[-1][4]:.3f} dB, block errors "
             f"{recs[0][6]}/{recs[0][5]} -> {recs[-1][6]}/{recs[-1][5]}, K4 launches "
             f"{launches_c} | campaign_blocks_per_s kernel path {blocks / dt:.1f} | "
             f"cut to the first {PLAIN_CAMPAIGN_POINTS} points ({cut_blocks} blocks): "
             f"kernel path {cut_blocks / dt_k:.1f}, plain path "
             f"{sum(r[5] for r in cut_p) / dt_p:.1f} blocks/s, records equal")

    return {"name": "bp_decode", "route": "cuda",
            "source": "ldpc_sparc_tpu_torch/csrc/bp_decode.cu",
            "replaces": "ldpc_sparc_tpu/ops/bp_pallas.py:56",
            "launches": launches, "max_abs_err": k4_err,
            "ms": k4_ms, "plain_ms": k4_plain_ms, **k4_bound, "library_ms": None}


def sc_inputs(design, params, batch, dev):
    """(beta0, y) of `batch` random SC codewords at SC_AWGN: bits and noise
    from a CPU generator seeded SEED (a CPU run reproduces them), the
    codeword through the plain float32 product."""
    import torch
    from ldpc_sparc_tpu_torch.utils import bits as bitops
    gen = torch.Generator().manual_seed(SEED)
    bits = torch.randint(0, 2, (batch, params.bit_len), generator=gen).bool()
    noise = torch.randn(batch, design.n, generator=gen)
    beta0 = bitops.bits_to_msg_vector(bits.to(dev), params.M)
    x = design.ab(beta0, fwht_kernel=False)
    return beta0, x + SC_AWGN ** 0.5 * noise.to(dev)


def slice_c(dev, card, errs):
    """Phases 9-11; returns K2's entry of the kernels line. K1 and K3 are
    also checked against their plain versions at the SC decode's shapes,
    and their errors there join `errs`."""
    import os
    import tempfile
    import torch
    from ldpc_sparc_tpu_torch import DecodeParams, SparcDesign, SparcParams, sparc_se
    from ldpc_sparc_tpu_torch.models.sparc import decode_batch
    from ldpc_sparc_tpu_torch.ops import denoiser_cuda, wht_cuda

    params = SparcParams(**SC)
    design = SparcDesign.for_params(params, SC_AWGN, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # -- 9: K2 against its plain version ----------------------------------------
    exact = []
    for log_w in K2_TERNARY_LOG_W:
        w = 1 << log_w
        x = torch.randint(-1, 2, (4, w), generator=gen, device=dev).float()
        signs = (torch.randint(0, 2, (2, w), generator=gen, device=dev) * 2 - 1).float()
        for sg, pre in ((signs, True), (signs, False), (None, True)):
            got = wht_cuda.fwht_signed_2mm(x, sg, pre)
            want = wht_cuda.fwht_signed_ref(x, sg, pre)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K2 on ternary rows at 2^{log_w} pre={pre} "
                                     f"signs={sg is not None} is not exact")
        exact.append(f"2^{log_w}")
    k2_err, parts, times, unsigned = 0.0, [], {}, {}
    head_signs = (torch.randint(0, 2, (1, 1 << 19), generator=gen, device=dev) * 2
                  - 1).float()
    for name, rows, signs in (("SC", SC_BATCH * design.E, design.signs),
                              ("headline", BATCH, head_signs)):
        x = torch.randn(rows, signs.shape[1], generator=gen, device=dev)
        for pre in (True, False):
            got = wht_cuda.fwht_signed_2mm(x, signs, pre)
            want = wht_cuda.fwht_signed_2mm_ref(x, signs, pre)
            torch.cuda.synchronize()
            rel = float((got - want).norm() / want.norm())
            err = float((got - want).abs().max())
            del want
            f32 = wht_cuda.fwht_signed(x, signs, pre)
            torch.cuda.synchronize()
            f32_rel = float((got - f32).abs().max() / f32.abs().mean())
            del got
            k1_err, k1_bound = fwht_err(f32, wht_cuda.fwht_signed_ref(x, signs, pre))
            del f32
            if not k1_err <= k1_bound:
                raise AssertionError(f"fwht_signed vs plain at {name} pre={pre}: "
                                     f"{k1_err} > {k1_bound}")
            errs["fwht_signed"] = max(errs["fwht_signed"], k1_err)
            if not rel <= K2_REL_BOUND:
                raise AssertionError(f"K2 vs plain at {name} pre={pre}: relative "
                                     f"error {rel} > {K2_REL_BOUND}")
            if not f32_rel <= K2_F32_BOUND:
                raise AssertionError(f"K2 vs float32 K1 at {name} pre={pre}: "
                                     f"{f32_rel} > {K2_F32_BOUND}")
            k2_err = max(k2_err, err)
            times[name, pre] = (
                cuda_ms(lambda: wht_cuda.fwht_signed_2mm(x, signs, pre)),
                cuda_ms(lambda: wht_cuda.fwht_signed_2mm_ref(x, signs, pre), reps=2,
                        warmup=1),
                cuda_ms(lambda: wht_cuda.fwht_signed(x, signs, pre)),
                cuda_ms(lambda: wht_cuda.fwht_signed_ref(x, signs, pre), reps=2,
                        warmup=1))
            parts.append(f"{name} ({rows}, 2^{signs.shape[1].bit_length() - 1}) "
                         f"{'pre' if pre else 'post'}: rel {rel:.2e}, max|d| {err:.2e}, "
                         f"vs f32 K1 {f32_rel:.4f}; K1 vs its plain version max|d| "
                         f"{k1_err:.2e} (bound {k1_bound:.2e}); K2 "
                         f"{times[name, pre][0]:.4f} ms, plain "
                         f"{times[name, pre][1]:.4f} ms, K1 {times[name, pre][2]:.4f} "
                         f"ms, K1's plain {times[name, pre][3]:.4f} ms")
        # unsigned; the mma.sync kernel beside the table's where it takes the
        # width; the wide layout's two launches singly
        extra = {"no signs": cuda_ms(lambda: wht_cuda.fwht_signed_2mm(x, None, False))}
        if wht_cuda.k2_layout(signs.shape[1].bit_length() - 1)[1] == "tile":
            extra["mma.sync kernel pre"] = cuda_ms(
                lambda: wht_cuda.fwht_signed_2mm(x, signs, True, kernel="mma"))
            extra["mma.sync kernel no signs"] = cuda_ms(
                lambda: wht_cuda.fwht_signed_2mm(x, None, False, kernel="mma"))
        else:
            for p in (1, 2):
                extra[f"launch {p} (post)"] = cuda_ms(
                    lambda: wht_cuda.fwht_signed_2mm(x, signs, False, passes=p))
        unsigned[name] = ", ".join(f"{k} {v:.4f} ms" for k, v in extra.items())
        del x
    sc_shape = (SC_BATCH * design.E, design.E, design.idx.shape[1],
                design.w.bit_length() - 1)
    if sc_shape != SC_SRHT:
        raise AssertionError(f"the SC design's index side is {sc_shape}")
    k1_t = time_k1(SC_SRHT, design._idx32, design.signs, ("block", "two_pass"),
                   gen, dev)
    # the library's yardstick for K2: the pair of cuBLAS bf16 products
    # ha @ (x @ hb) on the (a, b) view, operands already in bf16
    lib_ms = {}
    for name, rows, width in (("SC", SC_SRHT[0], design.w),
                              ("headline", BATCH, 1 << 19)):
        a, b = wht_cuda.split_ab(width)
        ha = wht_cuda.hadamard_factor(a, torch.bfloat16, dev)
        hb = wht_cuda.hadamard_factor(b, torch.bfloat16, dev)
        xb = torch.randn(rows, a, b, generator=gen, device=dev).to(torch.bfloat16)
        lib_ms[name] = cuda_ms(lambda: ha @ (xb @ hb))
        del xb
    a, b = wht_cuda.split_ab(design.w)
    k2_bound = least_ms(4 * (2 * SC_SRHT[0] * design.w + design.E * design.w),
                     2 * SC_SRHT[0] * (a * b * b + a * a * b), BF16_FLOPS)
    a, b = wht_cuda.split_ab(1 << 19)
    head_bound = least_ms(4 * (2 * BATCH + 1) * (1 << 19),
                          2 * BATCH * (a * b * b + a * a * b), BF16_FLOPS)
    phase(9, f"fwht_signed_2mm on {card}: bit-exact on ternary rows at "
             f"{', '.join(exact)} (pre, post, no signs; kernel and layout by "
             f"`k2_layout`); Gaussian rows against "
             f"plain (relative Frobenius <= {K2_REL_BOUND:g}) and against float32 K1 "
             f"(max|d|/mean|K1| <= {K2_F32_BOUND:g}); K1 against its plain version "
             f"(max|d| <= {FWHT_REL_BOUND:g} max|ref|): " + "; ".join(parts)
             + f" | K1 at {SC_SRHT} by route and its fused products, ms: "
             + ", ".join(f"{k} {v:.4f}" for k, v in k1_t.items())
             + " | K2 " + "; ".join(f"{k}: {v}" for k, v in unsigned.items())
             + f" | K2's bound at the SC shape {k2_bound['bound_ms']:.4f} ms by "
             f"{k2_bound['bound_by']}, at the headline's {head_bound['bound_ms']:.4f} "
             f"ms by {head_bound['bound_by']}; the pair of cuBLAS bf16 products "
             f"ha @ (x @ hb) SC {lib_ms['SC']:.4f} ms, headline "
             f"{lib_ms['headline']:.4f} ms")

    # -- 10: the SC decode through K1+K3, K2+K3 and the plain path --------------
    # K3 against its plain version at the SC decode's (batch, L, M) first
    shape = (SC_BATCH, params.L, params.M)
    beta = torch.softmax(3 * torch.randn(shape, generator=gen, device=dev),
                         -1).reshape(SC_BATCH, -1)
    azo = 2 * torch.randn(SC_BATCH, params.L * params.M, generator=gen, device=dev)
    tau = 0.5 + 1.5 * torch.rand(SC_BATCH, params.L, generator=gen, device=dev)
    got = denoiser_cuda.fused_denoise_update(beta, azo, tau, params.M)
    want = denoiser_cuda.fused_denoise_update_ref(beta, azo, tau, params.M)
    torch.cuda.synchronize()
    k3_parts = []
    for key, g, w_ in zip(DENOISE_TOL, got, want):
        torch.testing.assert_close(g, w_, rtol=DENOISE_TOL[key][0],
                                   atol=DENOISE_TOL[key][1])
        e = float((g - w_).abs().max())
        errs["fused_denoise_update"] = max(errs["fused_denoise_update"], e)
        k3_parts.append(f"{key} {e:.2e}")
    k3_ms = (cuda_ms(lambda: denoiser_cuda.fused_denoise_update(beta, azo, tau,
                                                                params.M)),
             cuda_ms(lambda: denoiser_cuda.fused_denoise_update_ref(beta, azo, tau,
                                                                    params.M), reps=5))
    del beta, azo, tau, got, want

    decode = DecodeParams(t_max=SC_T_MAX)
    beta0, y = sc_inputs(design, params, SC_BATCH, dev)
    paths = {"K1+K3": {}, "K2+K3": dict(fwht_mode="2mm"),
             "plain": dict(fused_denoiser=False, fwht_kernel=False)}
    out, counts = {}, {}
    for name, kw in paths.items():
        wht_cuda.LAUNCHES = wht_cuda.LAUNCHES_2MM = denoiser_cuda.LAUNCHES = 0
        out[name] = decode_batch(y, design, params, decode, SC_AWGN, **kw)
        torch.cuda.synchronize()
        counts[name] = (wht_cuda.LAUNCHES, wht_cuda.LAUNCHES_2MM,
                        denoiser_cuda.LAUNCHES)
    it = SC_T_MAX - 1
    want_counts = {"K1+K3": (2 * it - 1, 0, it), "K2+K3": (0, 2 * it - 1, it),
                   "plain": (0, 0, 0)}
    if counts != want_counts:
        raise AssertionError(f"SC decode launches (K1, K2, K3) {counts}, "
                             f"expected {want_counts}")
    sec_errs = {}
    for name, (beta, t_final) in out.items():
        if beta.shape != beta0.shape or not bool(torch.isfinite(beta).all()):
            raise AssertionError(f"SC decode {name}: wrong shape or not finite")
        sec_errs[name] = int((beta != beta0).reshape(SC_BATCH, params.L, -1)
                             .any(-1).sum())
    (b1, t1), (b2, t2), (bp, tp) = out["K1+K3"], out["K2+K3"], out["plain"]
    if sec_errs["plain"] != 0:
        raise AssertionError(f"SC decode plain path: {sec_errs['plain']} section errors")
    if not torch.equal(b1, bp):
        raise AssertionError("SC decode: K1+K3 and plain decisions differ")
    if int((t1 - tp).abs().max()) > 1:
        raise AssertionError(f"SC decode: t_final differs by more than 1: "
                             f"{t1.tolist()} vs {tp.tolist()}")
    if sec_errs["K2+K3"] > sec_errs["plain"]:
        raise AssertionError(f"SC decode K2+K3: {sec_errs['K2+K3']} section errors")

    def window(kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(SC_REPS):
            decode_batch(y, design, params, decode, SC_AWGN, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    best = {k: float("inf") for k in paths}
    for i in range(4):   # alternate the order: K1, K2, plain, plain, K2, K1, ...
        for name in (list(paths) if i % 2 == 0 else list(paths)[::-1]):
            best[name] = min(best[name], window(paths[name]))
    rate = {k: SC_BATCH * it * SC_REPS / v for k, v in best.items()}
    tf = {k: f"{int(t.min())}-{int(t.max())}" for k, (_, t) in out.items()}
    phase(10, f"SC decode L={SC['L']} M={SC['M']} omega={SC['omega']} "
              f"Lambda={SC['Lambda']} R={SC['R']} awgn_var {SC_AWGN} t_max {SC_T_MAX} "
              f"batch {SC_BATCH} (E={design.E}, w=2^{design.w.bit_length() - 1}) on "
              f"{card}: fused_denoise_update vs plain at {shape}: "
              + ", ".join(k3_parts) + f" ({k3_ms[0]:.4f} ms, plain {k3_ms[1]:.4f} "
              f"ms) | section errors {sec_errs} | t_final {tf} | launches "
              f"(K1, K2, K3) {counts} | K1+K3 decisions equal to plain, t_final "
              f"within 1 | sc_amp_iterations_per_s "
              + ", ".join(f"{k} {v:.1f} (best window {best[k]:.4f} s)"
                          for k, v in rate.items()))
    del y, beta0, out

    # -- 11: the sparc-sweep entry point, through K2, then resumed ---------------
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "ldpc_sparc_tpu_torch.cli", "sparc-sweep",
               *SWEEP_FLAGS, "--out", tmp]
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        t0 = time.perf_counter()
        first = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                               env=env)
        dt = time.perf_counter() - t0
        if first.returncode != 0:
            raise AssertionError(f"sparc-sweep failed:\n{first.stderr[-3000:]}")
        store = os.path.join(tmp, "sparc_sweep.jsonl")
        with open(store) as f:
            rows = [json.loads(ln) for ln in f if ln.strip()]
        t0 = time.perf_counter()
        again = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                               env=env)
        dt_again = time.perf_counter() - t0
        with open(store) as f:
            n_lines = sum(1 for ln in f if ln.strip())
    if again.returncode != 0 or again.stdout.strip() or n_lines != len(rows):
        raise AssertionError(f"sparc-sweep rerun decoded again or failed: "
                             f"{again.stdout!r} {again.stderr[-2000:]}")
    keys = ("key", "awgn_var", "ber", "ser", "fer", "avg_iters", "bit_errs", "bits",
            "sec_errs", "sections", "frame_errs", "frames", "iters", "snr", "snr_db")
    if len(rows) != 3 or any(
            set(r) != set(keys) or r["bits"] != SWEEP_TRIALS * params.bit_len
            or r["frames"] != SWEEP_TRIALS or not 0 <= r["ber"] <= 1 for r in rows):
        raise AssertionError(f"sparc-sweep rows are malformed: {rows}")
    rows.sort(key=lambda r: r["snr"])
    if not all(b["ber"] <= a["ber"] for a, b in zip(rows, rows[1:])):
        raise AssertionError("sparc-sweep BER rises with SNR")
    se = [float(sparc_se(r["awgn_var"], params, SC_T_MAX, 2000, seed=SEED,
                         device=dev)[0][-1].mean()) for r in rows]
    phase(11, f"sparc-sweep --fwht-mode 2mm on the SC code, {SWEEP_TRIALS} trials "
              f"per point, "
              f"on {card}: {dt:.1f} s, rerun {dt_again:.1f} s decoding nothing | "
              + ", ".join(f"SNR {r['snr']:g}: BER {r['ber']:.3e} SER {r['ser']:.3e} "
                          f"FER {r['fer']:.3f} avg iters {r['avg_iters']:.2f}, SE "
                          f"final psi {p:.3e}" for r, p in zip(rows, se)))

    return {"name": "fwht_signed_2mm", "route": "cuda",
            "source": "ldpc_sparc_tpu_torch/csrc/fwht_2mm.cu",
            "replaces": "ldpc_sparc_tpu/ops/wht_pallas.py:103",
            "launches": counts["K2+K3"][1], "max_abs_err": k2_err,
            "ms": (times["SC", True][0] + times["SC", False][0]) / 2,
            "plain_ms": (times["SC", True][1] + times["SC", False][1]) / 2,
            **k2_bound, "library_ms": lib_ms["SC"]}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA device; this check runs "
                 "only on an NVIDIA card")
    from ldpc_sparc_tpu_torch import _build, DecodeParams, SparcDesign, SparcParams
    from ldpc_sparc_tpu_torch.models.sparc import awgn_channel, decode_batch
    from ldpc_sparc_tpu_torch.ops import denoiser_cuda, wht_cuda
    from ldpc_sparc_tpu_torch.utils import bits as bitops
    from ldpc_sparc_tpu_torch.utils.metrics import bit_error_rate

    dev = torch.device("cuda")
    # the plain FWHT is a chain of float32 matmuls: TF32 would break parity
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 0: device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    phase(0, f"device: {card} | torch {torch.__version__} | "
             f"cuda {torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
             f"{torch.cuda.device_count()}")

    # -- 1: build -------------------------------------------------------------
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.load()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "Used" in ln or "Compiling entry" in ln or "spill" in ln]
    phase(1, f"build: {time.perf_counter() - t0:.1f} s -> {path.name}"
             + (" | " + " / ".join(ptxas) if ptxas else " (cached)"))

    gen = torch.Generator(device=dev).manual_seed(SEED)
    errs = {"fwht_signed": 0.0, "fused_denoise_update": 0.0}

    # -- 2: K1 against its plain version ----------------------------------------
    # every route at its widths, three sign modes: Gaussian rows within the
    # bound; rows with entries in {-1, 0, 1} bit for bit (every partial sum is
    # an integer below 2^24, exact in float32 in any order, so a wrong index
    # or sign cannot hide behind a tolerance)
    E, B = 2, 4   # E*B = 8 rows; row r uses sign row r % E
    checked = []
    for route, widths in K1_ROUTE_WIDTHS:
        for log_w in widths:
            w = 1 << log_w
            xg = torch.randn(E * B, w, generator=gen, device=dev)
            xt = torch.randint(-1, 2, (E * B, w), generator=gen, device=dev).float()
            signs = (torch.randint(0, 2, (E, w), generator=gen, device=dev) * 2 - 1
                     ).float()
            worst = 0.0
            for sg, pre in ((signs, True), (signs, False), (None, False)):
                what = (f"fwht_signed w=2^{log_w} route={route} pre={pre} "
                        f"signs={sg is not None}")
                got = wht_cuda.fwht_signed(xt, sg, pre, route=route)
                want = wht_cuda.fwht_signed_ref(xt, sg, pre)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{what}: not bit-equal on ternary rows")
                got = wht_cuda.fwht_signed(xg, sg, pre, route=route)
                want = wht_cuda.fwht_signed_ref(xg, sg, pre)
                torch.cuda.synchronize()
                err, lim = fwht_err(got, want)
                if not err <= lim:
                    raise AssertionError(f"{what}: {err} > {lim}")
                worst = max(worst, err)
            if log_w == 19:
                errs["fwht_signed"] = max(errs["fwht_signed"], worst)
            checked.append(f"2^{log_w} {route} {worst:.2e}")
            del xg, xt, signs, got, want
    fused = []
    for shape in (HEADLINE_SRHT, SC_SRHT):
        idx, signs = srht_inputs(shape, gen, dev)
        text, err = check_fused_srht(shape, idx, signs, gen, dev)
        fused.append(text)
        if shape is HEADLINE_SRHT:
            errs["fwht_signed"] = max(errs["fwht_signed"], err)
        del idx, signs
    x = torch.randn(E * B, 1 << 19, generator=gen, device=dev)
    hh = wht_cuda.fwht_signed(wht_cuda.fwht_signed(x, None, False), None, False)
    err, lim = fwht_err(hh, (1 << 19) * x)
    if not err <= lim:
        raise AssertionError(f"H(H(x)) != w x at 2^19: {err} > {lim}")
    del x, hh
    clusters = ", ".join(f"{wht_cuda.active_clusters(lw)} of "
                         f"{1 << (lw - wht_cuda.SEG_LOG_W)} blocks at 2^{lw}"
                         for lw in K1_ROUTE_WIDTHS[1][1])
    phase(2, f"fwht_signed vs plain, pre / post / no signs, ternary rows bit-equal "
             f"and Gaussian rows max|d| <= {FWHT_REL_BOUND:g} max|ref|: "
             + ", ".join(checked) + " | srht_scatter_fwht and srht_fwht_gather vs "
             "plain: " + "; ".join(fused) + f" | H(H(x)) = w x at 2^19 {err:.2e} | "
             f"clusters the card holds at once: {clusters}")

    # -- 3: K3 against its plain version ----------------------------------------
    beta = torch.softmax(3 * torch.randn(BATCH, L, M, generator=gen, device=dev),
                         -1).reshape(BATCH, L * M)
    azo = 2 * torch.randn(BATCH, L * M, generator=gen, device=dev)
    tau = 0.5 + 1.5 * torch.rand(BATCH, L, generator=gen, device=dev)
    got = denoiser_cuda.fused_denoise_update(beta, azo, tau, M)
    want = denoiser_cuda.fused_denoise_update_ref(beta, azo, tau, M)
    torch.cuda.synchronize()
    parts = []
    for name, g, w_ in zip(DENOISE_TOL, got, want):
        rtol, atol = DENOISE_TOL[name]
        torch.testing.assert_close(g, w_, rtol=rtol, atol=atol)
        e = float((g - w_).abs().max())
        errs["fused_denoise_update"] = max(errs["fused_denoise_update"], e)
        parts.append(f"{name} {e:.2e} (rtol {rtol:g})")
    phase(3, f"fused_denoise_update vs plain at ({BATCH}, {L}, {M}): "
             + ", ".join(parts))
    del beta, azo, tau, got, want

    # -- 4: the main path -------------------------------------------------------
    params = SparcParams(P=P, R=R, L=L, M=M)
    decode = DecodeParams(t_max=T_MAX)
    design = SparcDesign.for_params(params, AWGN_VAR, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    wht_cuda.LAUNCHES = 0
    denoiser_cuda.LAUNCHES = 0
    bits = bitops.random_bits(gen, BATCH * params.bit_len).reshape(
        BATCH, params.bit_len)
    beta0 = bitops.bits_to_msg_vector(bits, M)
    y = awgn_channel(design.ab(beta0), AWGN_VAR, gen)
    beta_k, t_k = decode_batch(y, design, params, decode, AWGN_VAR)
    bits_out = bitops.msg_vector_to_bits(beta_k, M)
    torch.cuda.synchronize()
    launches = {"fwht_signed": wht_cuda.LAUNCHES,
                "fused_denoise_update": denoiser_cuda.LAUNCHES}
    ber = float(bit_error_rate(bits, bits_out).mean())
    if ber != 0.0:
        raise AssertionError(f"main path BER {ber} != 0")
    if launches["fwht_signed"] < 2 * (T_MAX - 1) - 1:
        raise AssertionError(f"fwht_signed launched {launches} times")
    if launches["fused_denoise_update"] < T_MAX - 1:
        raise AssertionError(f"fused_denoise_update launched {launches} times")
    if beta_k.shape != (BATCH, L * M) or not bool(torch.isfinite(y).all()):
        raise AssertionError("main path output has the wrong shape or is not finite")
    beta_p, t_p = decode_batch(y, design, params, decode, AWGN_VAR,
                               fused_denoiser=False, fwht_kernel=False)
    torch.cuda.synchronize()
    if not torch.equal(beta_k, beta_p):
        n_diff = int((beta_k != beta_p).reshape(BATCH, -1).any(-1).sum())
        raise AssertionError(f"kernel and plain paths differ in {n_diff} decisions")
    if not torch.equal(t_k, t_p):
        raise AssertionError(f"t_final differs: {t_k.tolist()} vs {t_p.tolist()}")
    phase(4, f"main path L={L} M={M} R={R} batch {BATCH}: BER {ber} | launches "
             f"{launches} | t_final min/mean/max {int(t_k.min())}/"
             f"{float(t_k.float().mean()):.2f}/{int(t_k.max())} | kernel and "
             f"plain paths agree in every decision and t_final")

    # -- 5: timing --------------------------------------------------------------
    def decode_window(**kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            decode_batch(y, design, params, decode, AWGN_VAR, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    best = {"kernel": float("inf"), "plain": float("inf")}
    plain_kw = dict(fused_denoiser=False, fwht_kernel=False)
    for i in range(4):   # alternate: kernel, plain, plain, kernel, ...
        order = ("kernel", "plain") if i % 2 == 0 else ("plain", "kernel")
        for k in order:
            best[k] = min(best[k], decode_window(**({} if k == "kernel" else plain_kw)))
    iters = BATCH * (T_MAX - 1) * 5
    rate = {k: iters / v for k, v in best.items()}

    w = design.w
    xw = torch.randn(BATCH, w, generator=gen, device=dev)
    signs = design.signs
    k1 = {}
    for pre in (True, False):
        got = wht_cuda.fwht_signed(xw, signs, pre)
        want = wht_cuda.fwht_signed_ref(xw, signs, pre)
        torch.cuda.synchronize()
        err, lim = fwht_err(got, want)
        if not err <= lim:
            raise AssertionError(f"fwht_signed at ({BATCH}, {w}) pre={pre}: "
                                 f"{err} > {lim}")
        errs["fwht_signed"] = max(errs["fwht_signed"], err)
        del got, want
        k1[pre] = (cuda_ms(lambda: wht_cuda.fwht_signed(xw, signs, pre)),
                   cuda_ms(lambda: wht_cuda.fwht_signed_ref(xw, signs, pre), reps=5))
    del xw
    k1_t = time_k1(HEADLINE_SRHT, design._idx32, signs, ("cluster", "two_pass"),
                   gen, dev)
    beta = torch.softmax(3 * torch.randn(BATCH, L, M, generator=gen, device=dev),
                         -1).reshape(BATCH, L * M)
    azo = torch.randn(BATCH, L * M, generator=gen, device=dev)
    tau = 0.5 + torch.rand(BATCH, L, generator=gen, device=dev)
    k3 = (cuda_ms(lambda: denoiser_cuda.fused_denoise_update(beta, azo, tau, M)),
          cuda_ms(lambda: denoiser_cuda.fused_denoise_update_ref(beta, azo, tau, M),
                  reps=5))
    gb = BATCH * w * 4 / 1e9   # one f32 state array of the batch, GB
    # the card's copy bandwidth, for the byte model's floor
    src = torch.empty(BATCH, w, device=dev)
    dst = torch.empty_like(src)
    copy_gbs = 2e3 * gb / cuda_ms(lambda: dst.copy_(src))
    del src, dst
    phase(5, f"timing on {card}: AMP iterations/s kernel path {rate['kernel']:.1f} "
             f"(best window {best['kernel']:.4f} s), plain path {rate['plain']:.1f} "
             f"(best window {best['plain']:.4f} s) | fwht_signed ({BATCH}, {w}) pre "
             f"{k1[True][0]:.4f} ms (plain {k1[True][1]:.4f} ms), post "
             f"{k1[False][0]:.4f} ms (plain {k1[False][1]:.4f} ms), "
             f"{2e3 * gb / k1[True][0]:.0f} GB/s of the 8w bytes a row | K1 by route "
             f"and the fused products (k = {HEADLINE_SRHT[2]}), ms: "
             + ", ".join(f"{k} {v:.4f}" for k, v in k1_t.items())
             + f" | fused_denoise_update "
             f"({BATCH}, {L}, {M}) {k3[0]:.4f} ms (plain {k3[1]:.4f} ms), "
             f"{4e3 * gb / k3[0]:.0f} GB/s | device copy {copy_gbs:.0f} GB/s")

    k4 = slice_b(dev, card)
    k2 = slice_c(dev, card, errs)
    # K1 as the main path launches it: the two fused products, averaged. Each
    # reads or writes the (rows, w) side once, the (rows, k) side once, the
    # (E, w) signs and the (E, k) int32 indices; w log2(w) adds a row.
    rows, E, k, log_w = HEADLINE_SRHT
    k1_bytes = 4 * (rows * (w + k) + E * (w + k))
    kernels = [
        {"name": "fwht_signed", "route": "cuda",
         "source": "ldpc_sparc_tpu_torch/csrc/fwht_signed.cu",
         "replaces": "ldpc_sparc_tpu/ops/wht_pallas.py:138",
         "launches": launches["fwht_signed"],
         "max_abs_err": errs["fwht_signed"],
         "ms": (k1_t["scatter"] + k1_t["gather"]) / 2,
         "plain_ms": (k1_t["scatter plain"] + k1_t["gather plain"]) / 2,
         **least_ms(k1_bytes, rows * w * log_w), "library_ms": None},
        # K3 reads beta, azo and tau and writes s, beta_new and the section
        # energies; about 8 float32 operations an entry (scale, add, max,
        # subtract, exp, two sums, divide, square)
        {"name": "fused_denoise_update", "route": "cuda",
         "source": "ldpc_sparc_tpu_torch/csrc/denoise_update.cu",
         "replaces": "ldpc_sparc_tpu/ops/denoiser_pallas.py:67",
         "launches": launches["fused_denoise_update"],
         "max_abs_err": errs["fused_denoise_update"],
         "ms": k3[0], "plain_ms": k3[1],
         **least_ms(4 * (4 * BATCH * L * M + 2 * BATCH * L), 8 * BATCH * L * M),
         "library_ms": None},
    ]
    kernels.insert(1, k2)
    kernels.append(k4)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
