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
  * slice D: the concatenated LDPC-SPARC point `bench.py` times (802.16
    r=1/2 z=150, mults=4, M=2, L=14,400, n=14,400, P=19.44, R=1.0, t_max 25,
    awgn_var P/3.8, seed (3, 0), 20 trials). K1 at (20, 2^15) and K4 at
    (80 codewords, <= 6 and <= 200 iterations) against their plain versions,
    `decode_batch` through K1 + K4 against the plain path for `sequential`,
    `naive` and `integrated` and against the per-trial `decode` (phase 12);
    `concat_mc_trial_errors` timed with its three parts, and `concat-sweep`
    at linear SNR 2.0 and 4.286, resumed from its store and held to the rows
    of `docs/artifacts/concat_sweep.jsonl` (phase 13).
  * slice E: the complex K=4 PSK code of `docs/artifacts/modulated_sweep.json`
    (L=2048, M=8, R=2.6, P=15, t_max 25; n = 3,938 complex channel uses,
    LM = 2^14 at offset 0), 128 codewords at SNR 9 and 15, decoded through
    K1 on stacked real and imaginary rows (256 rows of 2^14) against the
    plain path, and the real K=2 code at the headline's widths (L=1024,
    M=512, 64 codewords, awgn_var 1) through K1 and through K2 (phase 14);
    `sparc-sweep --modulated` with both design engines held to
    `modulated_sweep.json` and `oracle_parity_mod_dft.json`, then resumed,
    and the K=1 sweeps held to `flagship_sweep.json`, `pa_sweep.json` and
    `sc_sweep.json` (phase 15); the campaign's per-point counter held to
    `campaign_tpu.json` (phase 16).
  * slice F: K4 against the port's own float64 C++ oracle on
    tests/test_ldpc.py's protocol (802.11n r=1/2 z=27, 2 dB, <= 60
    iterations, 64 codewords for each of sumprod, sumprod2 and minsum;
    phase 17); `ldpc-campaign --sim-id 7` at campaign_tpu.json's protocol,
    4 points, then its store cut to the first 2 points (what a run killed
    there leaves) and the campaign rerun, whose records must equal the
    uninterrupted run's; `results2csv --native` byte-identical to the
    Python converter and `plot-results` (phase 18); the mesh on the card:
    a world of one (`make_mesh()`, NCCL) for `sparc_mc_counts` at the
    headline shape and the z=150 concatenated point against `mesh=None`,
    the section-sharded step on the SC code at (1,1), its `decode(y)`
    against `decode_batch`, and the step at (1,2) on two ranks on this
    one card through gloo, whose counters must equal (1,1)'s (phase 19).
  * slice G, the rest of the TPU kernels' range: K2 with float32 operands
    (the wgmma kernels of its table and the mma.sync pass kernels by name)
    bit-exact on ternary rows and within 2.5e-6 of its plain version at the
    SC and headline shapes, the two kernels and the cuBLAS float32 pair
    timed in turns, the wide layout's two launches singly; the SC
    decode through it (path A, 64 codewords) against the plain path and
    timed beside K1 and bf16 K2; the headline decode through it (path B);
    `sparc-sweep --fwht-mode 2mm_f32` on the SC code and at two rows of
    `sc_sweep.json` (phase 20). K3 at sections of 2^13, 2^16 and 2^20
    against its plain version by every route that takes M (one block a
    section; from 2^16 the cluster route, a thread-block cluster of blocks a
    section), each run twice for the same bits and the routes timed in
    turns; a SPARC of L=64, M=8192 (path C, 256 codewords) and one of L=16,
    M=2^16, R=0.5 (path D, 16 codewords, K3's cluster route) through K1 and
    K3 against the plain path, both timed (phase 21). The port's three examples at full size: `sparc_demo`, one run a
    family; `sc_decode_wave` through K2 with float32 operands;
    `concat_probes` at z=150, 3 seeds, held to `concat_probes_tpu.json`,
    and each of its trials through K1 and K4 held to the plain path before
    and after BP (phase 22).
  * the holds against the reference's committed results that had no chip
    check: the min-sum waterfalls of `docs/artifacts/minsum_campaign.json`
    (802.16 r=1/2, 802.11n r=1/2, 802.16 r=3/4, z=27; batch 512, minsum
    0.7, <= 200 iterations, >= 100 block errors), all 22 points of each
    through K4, the cliff point and the point nearest BER 1e-4 gated by the
    two-sample bound on the block error rate, the SNR at BER 1e-4 within
    0.15 dB (phase 23, 2.5 s on an H100); `concat-sweep --semi-protected`
    at the three 25-run configurations of
    `docs/artifacts/concat_sweep_semi.jsonl` (802.11n r=5/6 z=81, M=64),
    amp_only and sequential at linear SNR 3.333 and 6.0, naive at 6.0,
    each row held to the artifact's row of the same key, and the
    prefix-floor law on the port's rows (phase 24, 0.6 s). Phases 21-24 add
    about 15 s to the script, which took about 230 s in all with the build
    on an H100.

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

# slice D: bench.py's concatenated point (bench.py:136-156)
CONCAT = dict(standard="802.16", rate="1/2", z=150, mults=4, logM=1, P=19.44,
              R_sparc=1.0, t_max=25)
CONCAT_SNR, CONCAT_SEED, CONCAT_TRIALS, CONCAT_DECODER = 3.8, (3, 0), 20, "integrated"
CONCAT_BP_ITERS = (6, 200)            # ConcatCodec.decode's inner and final BP
CONCAT_PATHS = ("sequential", "naive", "integrated")
# K1 + K4 against the plain path: K4 is bit-equal to the plain BP decode and
# K1 differs from the plain FWHT chain in the order of its float32 adds, so
# a trial that the plain path decodes without error must decode without
# error; on a trial that does not converge the rounding is amplified and the
# two counts may differ by at most this share of the trial's user bits
CONCAT_COUNT_TOL = 0.01
# phase 13: concat-sweep at the two ends of the waterfall; BER at SNR 2.0
# within this of the artifact's row of the same decoder (20 trials of 7,200
# bits against 25: the rows' own spread across 3, 5 and 25 runs is 0.002)
CONCAT_SWEEP_SNRS, CONCAT_SWEEP_RUNS, CONCAT_BER_TOL = (2.0, 4.286), 20, 0.03
CONCAT_SWEEP_DECODERS = ("amp_only", "sequential", "naive", "integrated")
CONCAT_ARTIFACT = "docs/artifacts/concat_sweep.jsonl"

# slice E: the K=4 PSK code of docs/artifacts/modulated_sweep.json (the
# reference's demo cell 14), and the real K=2 code at the headline's widths
MOD = dict(P=15.0, R=2.6, L=2048, M=8, modulated=True, K=4, is_complex=True)
MOD_T_MAX, MOD_BATCH, MOD_REPS, MOD_SNRS = 25, 128, 3, (9.0, 15.0)
MOD_SRHT = (2 * MOD_BATCH, 1, 3938, 14)     # K1's (rows, E, k, log2 w) on this path
K2MOD = dict(P=15.0, R=1.0, L=1024, M=512, modulated=True, K=2)
K2MOD_BATCH, K2MOD_VAR = 64, 1.0
K2MOD_SRHT = (K2MOD_BATCH, 1, 10240, 19)
# phase 15: sparc-sweep --modulated at rows of the artifacts, their counts
MOD_SWEEP = ["sparc-sweep", "--P", "15", "--R", "2.6", "--L", "2048", "--M", "8",
             "--modulated", "--K", "4", "--t-max", str(MOD_T_MAX), "--num-snrs", "1",
             "--device", "cuda"]
MOD_SWEEP_ROWS = {"srht": ("modulated_sweep.json", (6.5, 7.5, 9.0, 15.0), 128,
                           ("fer", "ser", "ler", "ver")),
                  "dft": ("oracle_parity_mod_dft.json", (8.0, 9.0), 256, ("fer", "ser"))}
MOD_SE_T_MAX, MOD_SE_SAMPLES = 300, 4000

# slice F: the oracle check (tests/test_ldpc.py:91-107's protocol), the
# campaign CLI at campaign_tpu.json's protocol, the mesh
ORACLE_CODE, ORACLE_SNR_DB, ORACLE_ITERS, ORACLE_TRIALS = ("802.11n", "1/2", 27), 2.0, 60, 64
ORACLE_DECTYPES = ("sumprod", "sumprod2", "minsum")
CAMPAIGN_CLI = ["ldpc-campaign", "--sim-id", "7", "--points", "4", "--batch", "512",
                "--dectype", "sumprod2", "--max-iters", "200", "--min-errors", "100",
                "--device", "cuda"]
CAMPAIGN_CUT = 2           # the points the cut store keeps
MESH_TRIALS = 16           # sparc_mc_counts at the headline shape on the mesh

# slice G: K2 with float32 operands (path A: the SC code above; path B: the
# headline) and K3 at M >= 8192 (path C). K2 with float32 operands (the
# wgmma kernels and the mma.sync pass kernels) against its plain
# version, two float32 matmuls with TF32 off: every partial product is
# exact (three bf16 planes against +-1) and only the float32 sums run in
# another order. max|d| <= 2.5e-6 max|ref|: the wgmma kernels read 3.2e-7
# to 1.81e-6 from 2^12 to 2^20, the pass kernels 2.1e-7 to 1.73e-6 from
# 2^8, a control without the lo plane 3.25e-6 to 4.11e-6 (time_k2.py
# --mm-dtype float32, 256 rows, PERF.md section 6)
K2F32_ABS_BOUND = 2.5e-6
K2F32_TERNARY_LOG_W = (8, 12, 15, 16, 19, 20)
PATH_C = dict(P=15.0, R=1.0, L=64, M=8192)     # LM = 2^19, n = 832
# path D: sections of 2^16, K3's cluster route (LM = 2^20, n = 512)
PATH_D, PATH_D_BATCH = dict(P=15.0, R=0.5, L=16, M=1 << 16), 16
PATH_REPS, PATH_WINDOWS = 3, 3
# K3 against its plain version at (batch, L, M): path C's (one block a
# section), path D's (the cluster route, C = 4), and a batch of 32 sections
# of 2^20 (clusters of 16, half of each share re-read)
K3_LONG_SHAPES = ((BATCH, 64, 1 << 13), (16, 16, 1 << 16), (4, 8, 1 << 20))
# beta_new and sec_en there: rtol as DENOISE_TOL, but an atol far below a
# softmax entry of 2^20 (about 1e-7), so that every entry is held
K3_LONG_ATOL = 1e-12
# phase 20's sweeps: path A's code at SNR 10 and 15 (K2 takes its 2^15
# windows), and sc_sweep.json's configuration at two of its rows (windows
# of 2^12: K1 serves them, as the JAX package's chain does)
F32_SWEEP = ["--P", "15", "--R", "1.5", "--L", "2048", "--M", "512",
             "--spatially-coupled", "--omega", "6", "--Lambda", "32",
             "--t-max", str(SC_T_MAX), "--trials", "16", "--num-snrs", "2",
             "--snr-start", "10", "--snr-stop", "15"]
SC_SWEEP_ROWS = ("sc_sweep.json", (9.5, 11.0))
# phase 22: concat_probes against the JAX package's run of it
PROBES = ("concat_probes_tpu.json", 3, 3.8)     # artifact, seeds, linear SNR
# and each of its trials through K1 and K4 against the plain path: at most
# 0.1 % of a trial's user bits decided otherwise at any AMP iteration, before
# or after BP (tests/test_torch_examples.py holds the plain path to the JAX
# package's decode_instrumented at this size)
PROBE_BITS_DIFFER = 1e-3


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


def bp_compare(got, want, max_iters, every=False):
    """The K4 gate (see K4_CASES). The APPs are held to BP_TOL on the
    codewords that stopped by parity, or on every codeword (`every`: for a
    cap of a few iterations, where rounding has had no time to grow). Fails
    if that set is empty. Returns (max |d app| over the set, number of
    codewords that ran to the cap, size of the set)."""
    import torch
    if not torch.equal(got.iterations, want.iterations):
        n = int((got.iterations != want.iterations).sum())
        raise AssertionError(f"iterations differ on {n} codewords")
    stopped = want.iterations < max_iters
    held = torch.ones_like(stopped) if every else stopped
    if not bool(held.any()):
        raise AssertionError("no codeword stopped by parity: nothing to compare")
    if not torch.equal(got.app[held] < 0, want.app[held] < 0):
        raise AssertionError("decisions differ on a compared codeword")
    torch.testing.assert_close(got.app[held], want.app[held],
                               rtol=BP_TOL[0], atol=BP_TOL[1])
    err = float((got.app[held] - want.app[held]).abs().max())
    return err, int((~stopped).sum()), int(held.sum())


def k4_bounds(graph, iterations, max_iters, N):
    """K4's bound from what a draw needs: ({"bound_ms", "bound_by"}, Lxor
    evaluations, operations, the slowest codeword's chain of dependent
    Lxors). A codeword that stops after `it` iterations runs
    min(it + 1, cap) check phases; a check of degree d takes 3 d - 5 Lxor
    evaluations (d - 2 forward prefixes, d - 1 backward suffixes, d - 2
    extrinsic outputs), each counted as 14 float32 operations (sign, two
    abs, min, a + b, a - b, two abs, two exp, two log1p, two adds); a
    variable phase takes 2 adds an edge. It reads the LLRs and writes the
    APPs and the iteration counts. The chain is the slowest codeword's
    phases times the 2 d_max - 3 Lxors that follow one another in the
    largest check."""
    import torch
    batch = iterations.numel()
    deg = (graph.chk_edges >= 0).sum(1)
    phases = torch.clamp(iterations.long() + 1, max=max_iters)
    n_lxor = int(phases.sum()) * graph.z * int((3 * deg - 5).sum())
    ops = 14 * n_lxor + 2 * graph.E * graph.z * int(phases.sum())
    bound = least_ms(4 * (2 * batch * N + batch), ops)
    return bound, n_lxor, ops, int(phases.max()) * (2 * int(deg.max()) - 3)


def slice_b(dev, card):
    """Phases 6-8; returns K4's entry of the kernels line and the latency
    of one dependent Lxor in microseconds."""
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
        err, capped, _ = bp_compare(got, want, iters)
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
    err, capped, _ = bp_compare(res, plain, BP_ITERS)
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
    k4_bound, n_lxor, k4_ops, chain = k4_bounds(code.graph, res.iterations, BP_ITERS,
                                                code.N)
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
            "ms": k4_ms, "plain_ms": k4_plain_ms, **k4_bound,
            "library_ms": None}, lxor_us


def sc_inputs(design, params, batch, dev, awgn_var=SC_AWGN):
    """(beta0, y) of `batch` random codewords of a real code at awgn_var
    (the SC code's by default): bits and noise from a CPU generator seeded
    SEED (a CPU run reproduces them), the codeword through the plain float32
    product."""
    import torch
    from ldpc_sparc_tpu_torch.utils import bits as bitops
    gen = torch.Generator().manual_seed(SEED)
    bits = torch.randint(0, 2, (batch, params.bit_len), generator=gen).bool()
    noise = torch.randn(batch, design.n, generator=gen)
    beta0 = bitops.bits_to_msg_vector(bits.to(dev), params.M, params.K)
    x = design.ab(beta0, fwht_kernel=False)
    return beta0, x + awgn_var ** 0.5 * noise.to(dev)


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


def concat_problem():
    """(sparc params, ldpc params, lengths, decode params, awgn_var) of
    CONCAT, by the port's `param_calc`."""
    from ldpc_sparc_tpu_torch import (DecodeParams, LdpcParams, SparcParams, get_code,
                                      param_calc)
    c = CONCAT
    ldpc = LdpcParams(standard=c["standard"], rate=c["rate"], z=c["z"])
    K = get_code(c["standard"], c["rate"], c["z"]).K
    _, _, L, lengths = param_calc(c["mults"], c["logM"], ldpc, ldpc.rate_float,
                                  c["R_sparc"], K)
    sp = SparcParams(P=c["P"], R=c["R_sparc"], L=L, M=2 ** c["logM"])
    return sp, ldpc, lengths, DecodeParams(t_max=c["t_max"]), c["P"] / CONCAT_SNR


def slice_d(dev, card, lxor_us):
    """Phases 12-13; returns the entries of K1 and K4 at the concatenated
    path's shapes for the kernels line."""
    import os
    import tempfile
    import torch
    from ldpc_sparc_tpu_torch import ConcatCodec, _build, concat_mc_trial_errors
    from ldpc_sparc_tpu_torch.ops import bp_cuda, denoiser_cuda, wht_cuda
    from ldpc_sparc_tpu_torch.ops.bridges import (bit_probs_to_section_probs,
                                                  section_probs_to_bit_probs)
    from ldpc_sparc_tpu_torch.parallel.montecarlo import (concat_mc_designs,
                                                          concat_mc_transmit)

    sp, ldpc, lengths, dp, awgn_var = concat_problem()
    codec = ConcatCodec(sp, ldpc, lengths, True)
    B, bi, bf = CONCAT_TRIALS, *CONCAT_BP_ITERS
    designs = concat_mc_designs(codec, CONCAT_SEED, B, device=dev)
    user_bits, ys = concat_mc_transmit(codec, designs, awgn_var, CONCAT_SEED)
    if (designs.w, designs.offset, designs.LM, designs.n) != (1 << 15, 1, 28800, 14400):
        raise AssertionError(f"the concatenated design is w={designs.w} "
                             f"offset={designs.offset} LM={designs.LM} n={designs.n}")

    # -- 12: K1 and K4 at this path's shapes, then the decode through them -------
    w = designs.w
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xw = torch.randn(B, w, generator=gen, device=dev)
    got, want = wht_cuda.fwht_signed(xw, None, True), wht_cuda.fwht_signed_ref(xw, None, True)
    torch.cuda.synchronize()
    k1_err, k1_lim = fwht_err(got, want)
    if not k1_err <= k1_lim:
        raise AssertionError(f"fwht_signed at ({B}, {w}) without signs: {k1_err} > {k1_lim}")
    k1_ms = cuda_ms(lambda: wht_cuda.fwht_signed(xw, None, True), reps=200)
    k1_plain_ms = cuda_ms(lambda: wht_cuda.fwht_signed_ref(xw, None, True), reps=20)
    # the floor under any launch: a one-warp kernel that loads and stores 32
    # floats, launched back to back
    lib, io = _build.load(), torch.ones(96, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    floor_ms = cuda_ms(lambda: lib.ldpc_bp_lxor_chain(io.data_ptr(), 0, 1, stream),
                       reps=500)
    k1_bound = least_ms(8 * w * B, B * w * (w.bit_length() - 1))
    del xw, got, want

    # K4's inputs as the decode makes them: the LLRs that each AMP iteration of
    # the plain `naive` decode hands to BP. In the first iteration no codeword
    # satisfies its checks within 200 BP iterations and in the last every one
    # does after few or none, so the one between is searched for: the iteration
    # where the most codewords stop by parity after at least one BP iteration.
    M, graph = sp.M, codec.code.graph
    beta, z, tau = torch.zeros(B, designs.LM, device=dev), torch.zeros_like(ys), \
        torch.ones(B, device=dev)
    llrs = []
    for _ in range(dp.t_max):
        z, s, tau = codec._amp_step(designs, ys, beta, z, tau, fwht_kernel=False)
        vk0 = section_probs_to_bit_probs(codec._mmse(s, tau) / codec.c_amp, M)
        llrs.append(codec._bit_llrs(vk0).reshape(-1, codec.code.N).contiguous())
        beta = codec.c_amp * bit_probs_to_section_probs(
            codec.ldpc_bp(vk0, bi, False, bp_kernel=False), M)
    working = [int(((it > 0) & (it < bf)).sum()) for it in (
        bp_cuda.bp_decode_kernel(llr, graph, bf, True, 0.7).iterations for llr in llrs[1:-1])]
    mid = 1 + max(range(len(working)), key=working.__getitem__)
    if not working[mid - 1]:
        raise AssertionError("no AMP iteration of the naive decode leaves BP a codeword "
                             "that stops by parity after at least one iteration")
    # (AMP iteration, cap, every codeword's APP compared or the stopped ones'):
    # the soft 6-iteration call on every codeword, the 200-iteration call on
    # those that stopped; the first iteration at 200 is timed only (the longest
    # K4 call a decode can make), none of its codewords stops
    cases = ((1, bi, True), (mid + 1, bi, True), (dp.t_max, bi, True),
             (mid + 1, bf, False), (dp.t_max, bf, False), (1, bf, None))
    k4_err, k4_parts, k4_first, k4_held = 0.0, [], None, 0
    for t, iters, every in cases:
        llr = llrs[t - 1]
        res_k = bp_cuda.bp_decode_kernel(llr, graph, iters, True, 0.7)
        res_p = bp_cuda.bp_decode_ref(llr, graph, iters, True, 0.7)
        torch.cuda.synchronize()
        if every is None:
            if not torch.equal(res_k.iterations, res_p.iterations):
                raise AssertionError(f"AMP iteration {t} <= {iters}: iterations differ")
            err, capped, held = float("nan"), int((res_p.iterations >= iters).sum()), 0
        else:
            err, capped, held = bp_compare(res_k, res_p, iters, every)
            k4_err, k4_held = max(k4_err, err), k4_held + held
        working_k = int(((res_k.iterations > 0) & (res_k.iterations < iters)).sum())
        ms = cuda_ms(lambda: bp_cuda.bp_decode_kernel(llr, graph, iters, True, 0.7),
                     reps=50)
        bound, n_lxor, ops, chain = k4_bounds(graph, res_k.iterations, iters, codec.code.N)
        if k4_first is None:
            plain_ms = cuda_ms(lambda: bp_cuda.bp_decode_ref(llr, graph, iters, True, 0.7),
                               reps=3, warmup=1)
            k4_first = dict(ms=ms, plain_ms=plain_ms, **bound)
        k4_parts.append(f"AMP iteration {t} <= {iters}: "
                        + (f"APP of {held} of {B * lengths.mults} codewords compared, "
                           f"max|d app| {err:.2e}" if held else "timed, no APP compared")
                        + f", iterations max {int(res_k.iterations.max())}, {capped} at "
                        f"the cap, {working_k} stopped by parity after 1 or more, "
                        f"{ms:.4f} ms (bound {bound['bound_ms']:.6f} ms by "
                        f"{bound['bound_by']}, {n_lxor} Lxors; chain of {chain} at "
                        f"{lxor_us:.4f} us {chain * lxor_us / 1e3:.4f} ms)")
    if llr.shape != (B * lengths.mults, codec.code.N):
        raise AssertionError(f"K4's batch on this path is {tuple(llr.shape)}")

    want_counts = {"sequential": (2 * dp.t_max - 1, 1),
                   "naive": (2 * dp.t_max, dp.t_max), "integrated": (2 * dp.t_max, dp.t_max)}
    counts, errs, outs, worst = {}, {}, {}, 0
    for d in CONCAT_PATHS:
        wht_cuda.LAUNCHES = wht_cuda.LAUNCHES_2MM = denoiser_cuda.LAUNCHES = 0
        bp_cuda.LAUNCHES = 0
        out_k = codec.decode_batch(ys, designs, dp, d, bi, bf)
        torch.cuda.synchronize()
        counts[d] = (wht_cuda.LAUNCHES, bp_cuda.LAUNCHES)
        if wht_cuda.LAUNCHES_2MM or denoiser_cuda.LAUNCHES:
            raise AssertionError("the concatenated decode launched K2 or K3")
        out_p = codec.decode_batch(ys, designs, dp, d, bi, bf, fwht_kernel=False,
                                   bp_kernel=False)
        torch.cuda.synchronize()
        if (wht_cuda.LAUNCHES, bp_cuda.LAUNCHES) != counts[d]:
            raise AssertionError("the plain path launched a kernel")
        if out_k.shape != (B, codec.user_bits_len) or out_k.dtype != torch.int32:
            raise AssertionError(f"decode_batch {d}: output {tuple(out_k.shape)} "
                                 f"{out_k.dtype}")
        e_k, e_p = (out_k != user_bits).sum(-1), (out_p != user_bits).sum(-1)
        errs[d], outs[d] = (e_k.tolist(), e_p.tolist()), out_k
        if bool((e_k[e_p == 0] != 0).any()):
            raise AssertionError(f"decode_batch {d}: a trial the plain path decodes "
                                 f"without error has errors through K1 + K4: {errs[d]}")
        diff = int((e_k - e_p).abs().max())
        worst = max(worst, diff)
        if diff > CONCAT_COUNT_TOL * codec.user_bits_len:
            raise AssertionError(f"decode_batch {d}: per-trial counts differ by {diff}: "
                                 f"{errs[d]}")
    if counts != want_counts or not all(k1 > 0 and k4 > 0 for k1, k4 in counts.values()):
        raise AssertionError(f"concatenated decode launches (K1, K4) {counts}, expected "
                             f"{want_counts}")
    if sum(errs["integrated"][0]) or sum(errs["naive"][0]):
        raise AssertionError(f"naive / integrated leave errors at SNR {CONCAT_SNR}: {errs}")
    if not sum(errs["sequential"][0]):
        raise AssertionError("sequential decodes everything: the comparison on trials "
                             "that do not converge is empty")
    # decode_batch against the per-trial decode, on 4 of the trials
    alone = 0
    for t in (0, 7, 8, 19):
        one = codec.build_design((CONCAT_SEED, t % min(8, B)), dev)
        for d in CONCAT_PATHS:
            bits = codec.decode(ys[t], one, dp, d, bi, bf)
            e = int((bits != user_bits[t]).sum())
            if abs(e - errs[d][0][t]) > CONCAT_COUNT_TOL * codec.user_bits_len or (
                    errs[d][0][t] == 0 and e != 0):
                raise AssertionError(f"decode {d} of trial {t} alone: {e} errors, "
                                     f"{errs[d][0][t]} in the batch")
            alone += torch.equal(bits, outs[d][t])
    torch.cuda.synchronize()
    phase(12, f"concatenated decode 802.16 r=1/2 z=150 mults=4 M=2 L={sp.L} n={codec.n} "
              f"t_max {dp.t_max} SNR {CONCAT_SNR} seed {CONCAT_SEED}, {B} trials decoded "
              f"as one batch (one design a row, gathered from 8; w=2^15, offset 1) on "
              f"{card}: fwht_signed ({B}, {w}) no signs vs plain max|d| {k1_err:.2e} "
              f"(bound {k1_lim:.2e}), {k1_ms:.5f} ms (plain {k1_plain_ms:.4f} ms; bound "
              f"{k1_bound['bound_ms']:.5f} ms by {k1_bound['bound_by']}; launch floor "
              f"{floor_ms:.5f} ms, a one-warp kernel back to back) | bp_decode_kernel "
              f"({B * lengths.mults} codewords, z=150, {bp_cuda.k4_variant(codec.code.graph)}"
              f") vs plain on the LLRs of the plain naive decode's AMP iterations, "
              f"iterations equal, APP within rtol {BP_TOL[0]:g} atol {BP_TOL[1]:g} on "
              f"{k4_held} codewords in all: " + "; ".join(k4_parts)
              + f"; plain {k4_first['plain_ms']:.4f} ms at AMP iteration 1 <= {bi} | "
              f"decode_batch through "
              f"K1 + K4 vs fwht_kernel=False, bp_kernel=False, per-trial user-bit errors "
              f"(kernel, plain): "
              + "; ".join(f"{d} {sum(e[0])}, {sum(e[1])} (trials with errors "
                          f"{sum(x > 0 for x in e[0])})" for d, e in errs.items())
              + f" | equal wherever the plain path decodes without error, largest "
              f"difference on the others {worst} bits (tolerance "
              f"{CONCAT_COUNT_TOL * codec.user_bits_len:.0f}) | launches (K1, K4) {counts} "
              f"| decode_batch vs decode of trials 0, 7, 8, 19 alone: {alone} of 12 "
              f"decisions torch.equal, counts within the tolerance")

    # -- 13: the timed point and the sweep ---------------------------------------
    def point():
        t = time.perf_counter()
        e = concat_mc_trial_errors(sp, ldpc, lengths, True, dp, awgn_var, CONCAT_SEED,
                                   CONCAT_TRIALS, CONCAT_DECODER, device=dev)
        return time.perf_counter() - t, e      # the counts come back through a copy

    def lap(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    _, e_mc = point()
    best = min(point()[0] for _ in range(3))
    # the same three calls that concat_mc_trial_errors makes, synchronised apart
    parts, t0 = {}, lap(0.0)
    codec2 = ConcatCodec(sp, ldpc, lengths, True)
    designs2 = concat_mc_designs(codec2, CONCAT_SEED, CONCAT_TRIALS, device=dev)
    parts["design_build_s"] = lap(t0)
    bits2, ys2 = concat_mc_transmit(codec2, designs2, awgn_var, CONCAT_SEED)
    parts["encode_channel_s"] = lap(t0) - parts["design_build_s"]
    e_split = (bits2 != codec2.decode_batch(ys2, designs2, dp, CONCAT_DECODER)
               ).sum(-1).cpu().numpy()
    split_s = lap(t0)
    parts["decode_s"] = split_s - parts["design_build_s"] - parts["encode_channel_s"]
    if e_split.tolist() != e_mc.tolist():
        raise AssertionError("the three parts called apart give other counts")
    ber = float(e_mc.sum()) / (CONCAT_TRIALS * codec.user_bits_len)
    if e_mc.shape != (CONCAT_TRIALS,) or e_mc.tolist() != errs[CONCAT_DECODER][0]:
        raise AssertionError(f"concat_mc_trial_errors {e_mc.tolist()} against phase 12's "
                             f"{errs[CONCAT_DECODER][0]}")

    argv = ["--runs", str(CONCAT_SWEEP_RUNS), "--num-snrs", str(len(CONCAT_SWEEP_SNRS)),
            "--snr-start", str(CONCAT_SWEEP_SNRS[0]), "--snr-stop",
            str(CONCAT_SWEEP_SNRS[-1]), "--decoders", ",".join(CONCAT_SWEEP_DECODERS),
            "--device", "cuda"]
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m", "ldpc_sparc_tpu_torch.cli", "concat-sweep", *argv,
               "--out", tmp]
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.perf_counter()
        first = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env)
        dt = time.perf_counter() - t0
        if first.returncode != 0:
            raise AssertionError(f"concat-sweep failed:\n{first.stderr[-3000:]}")
        store = os.path.join(tmp, "concat_sweep.jsonl")
        with open(store) as f:
            recs = [json.loads(ln) for ln in f if ln.strip()]
        t0 = time.perf_counter()
        again = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env)
        dt_again = time.perf_counter() - t0
        with open(store) as f:
            n_lines = sum(1 for ln in f if ln.strip())
    if again.returncode != 0 or again.stdout.strip() or n_lines != len(recs):
        raise AssertionError(f"concat-sweep rerun decoded again or failed: "
                             f"{again.stdout!r} {again.stderr[-2000:]}")
    meta, rows = recs[0], recs[1:]
    if not meta["key"].startswith("meta:") or meta["config"]["L_sparc_ldpc"] != sp.L \
            or len(rows) != len(CONCAT_SWEEP_SNRS) * len(CONCAT_SWEEP_DECODERS):
        raise AssertionError(f"concat-sweep store is malformed: {recs}")
    # the artifact's rows of the same configuration at 25 runs
    with open(os.path.join(root, CONCAT_ARTIFACT)) as f:
        art = [json.loads(ln) for ln in f if ln.strip()]
    art_cfg = [r["key"].split(":")[1] for r in art if r["key"].startswith("meta:")
               and r["config"]["runs"] == 25
               and {k: r["config"][k] for k in ("standard", "rate", "z", "P", "mults",
                                                 "logM", "R_sparc", "t_max")}
               == {k: meta["config"][k] for k in ("standard", "rate", "z", "P", "mults",
                                                   "logM", "R_sparc", "t_max")}]
    if len(art_cfg) != 1:
        raise AssertionError(f"{CONCAT_ARTIFACT} holds {len(art_cfg)} matching configurations")
    art_ber = {r["key"].split(":", 2)[2]: r["ber"] for r in art
               if r["key"].startswith(f"concat:{art_cfg[0]}:")}
    table = []
    for r in rows:
        want = art_ber[r["key"].split(":", 2)[2]]
        low = abs(r["snr"] - CONCAT_SWEEP_SNRS[0]) < 1e-9
        ok = (abs(r["ber"] - want) <= CONCAT_BER_TOL if low else
              (r["bit_errs"] == 0) == (r["decoder"] in ("naive", "integrated")))
        if not ok or r["frames"] != CONCAT_SWEEP_RUNS:
            raise AssertionError(f"concat-sweep row {r} against the artifact's BER {want}")
        table.append(f"{r['decoder']} SNR {r['snr']:g}: BER {r['ber']:.5f} "
                     f"(artifact {want:.5f})")
    phase(13, f"concat_mc_trial_errors z=150 {CONCAT_DECODER}, {CONCAT_TRIALS} trials "
              f"decoded, SNR {CONCAT_SNR}, seed {CONCAT_SEED} on {card}: "
              f"concat_z150_integrated_point_s {best:.6f} (best of 3 after a warm-up) | "
              f"concat_z150_trials_per_s {CONCAT_TRIALS / best:.2f} | its three calls "
              f"once more, synchronised apart, {split_s:.6f} s: design build "
              f"{parts['design_build_s']:.6f} s, encode + channel "
              f"{parts['encode_channel_s']:.6f} s, decode {parts['decode_s']:.6f} s | "
              f"BER {ber:.5f}, per-trial errors equal to phase 12's | concat-sweep "
              f"--runs {CONCAT_SWEEP_RUNS}: {dt:.1f} s, rerun {dt_again:.1f} s decoding "
              f"nothing; at SNR {CONCAT_SWEEP_SNRS[0]:g} BER within {CONCAT_BER_TOL} of "
              f"{CONCAT_ARTIFACT}'s 25-run rows, at {CONCAT_SWEEP_SNRS[-1]:g} naive and "
              f"integrated count 0 errors and amp_only and sequential more: "
              + ", ".join(table))

    common = {"route": "cuda", "library_ms": None}
    return ({"name": "fwht_signed (concatenated decode)", **common,
             "source": "ldpc_sparc_tpu_torch/csrc/fwht_signed.cu",
             "replaces": "ldpc_sparc_tpu/ops/wht_pallas.py:138",
             "launches": counts[CONCAT_DECODER][0], "max_abs_err": k1_err,
             "ms": k1_ms, "plain_ms": k1_plain_ms, **k1_bound},
            {"name": "bp_decode (concatenated decode)", **common,
             "source": "ldpc_sparc_tpu_torch/csrc/bp_decode.cu",
             "replaces": "ldpc_sparc_tpu/ops/bp_pallas.py:56",
             "launches": counts[CONCAT_DECODER][1], "max_abs_err": k4_err, **k4_first})


def converged_equal(got, plain, t_max):
    """The decode gate of slice E: decisions and t_final equal to the plain
    path's on every codeword whose plain decode stopped before the cap.
    Returns the number of such codewords (fails if none)."""
    import torch
    (b_k, t_k), (b_p, t_p) = got, plain
    conv = t_p < t_max - 1
    if not bool(conv.any()):
        raise AssertionError("no codeword converges on the plain path")
    if not (torch.equal(b_k[conv], b_p[conv]) and torch.equal(t_k[conv], t_p[conv])):
        n = int((b_k[conv] != b_p[conv]).reshape(int(conv.sum()), -1).any(-1).sum())
        raise AssertionError(f"decisions or t_final differ on {n} converged codewords")
    return int(conv.sum())


def slice_e(dev, card):
    """Phase 14; returns the entries of K1 at the K=4 and K=2 shapes and of
    K2 at the K=2 shape for the kernels line."""
    import torch
    from ldpc_sparc_tpu_torch import DecodeParams, SparcDesign, SparcParams
    from ldpc_sparc_tpu_torch.models.sparc import awgn_channel, decode_batch
    from ldpc_sparc_tpu_torch.ops import denoiser_cuda, wht_cuda
    from ldpc_sparc_tpu_torch.utils import bits as bitops

    params, decode = SparcParams(**MOD), DecodeParams(t_max=MOD_T_MAX)
    it = MOD_T_MAX - 1
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # K1 at this path's shape against its plain version, then timed
    design = SparcDesign.for_params(params, MOD["P"] / MOD_SNRS[0], seed=SEED, device=dev)
    shape = (2 * MOD_BATCH, design.E, design.idx.shape[1], design.w.bit_length() - 1)
    if (shape, design.offset, design.n, design.tall) != (MOD_SRHT, 0, 3938, False):
        raise AssertionError(f"the K=4 design is {shape} offset {design.offset}")
    k1_text, k1_err = check_fused_srht(MOD_SRHT, design._idx32, design.signs, gen, dev)
    k1_t = time_k1(MOD_SRHT, design._idx32, design.signs, ("block",), gen, dev)
    rows, E, k, log_w = MOD_SRHT
    k1_bound = least_ms(4 * ((1 << log_w) + k) * (rows + E), rows * (1 << log_w) * log_w)

    # the main path at two SNRs: encode and decode through K1, then plain
    parts, launches, ys = [], {}, {}
    for snr in MOD_SNRS:
        var = MOD["P"] / snr
        design = SparcDesign.for_params(params, var, seed=SEED, device=dev)
        g = torch.Generator(device=dev).manual_seed(SEED)
        wht_cuda.LAUNCHES = wht_cuda.LAUNCHES_2MM = denoiser_cuda.LAUNCHES = 0
        bits = bitops.random_bits(g, MOD_BATCH * params.bit_len).reshape(MOD_BATCH, -1)
        beta0 = bitops.bits_to_msg_vector(bits, params.M, params.K)
        y = awgn_channel(design.ab(beta0), var, g)
        got = decode_batch(y, design, params, decode, var)
        torch.cuda.synchronize()
        launches[snr] = (wht_cuda.LAUNCHES, wht_cuda.LAUNCHES_2MM, denoiser_cuda.LAUNCHES)
        if launches[snr] != (2 * it, 0, 0):
            raise AssertionError(f"K=4 path launches (K1, K2, K3) {launches[snr]}, "
                                 f"expected {(2 * it, 0, 0)}")
        if got[0].shape != beta0.shape or got[0].dtype != torch.complex64 \
                or not bool(torch.isfinite(torch.view_as_real(y)).all()):
            raise AssertionError("K=4 decode: wrong shape or type, or not finite")
        plain = decode_batch(y, design, params, decode, var, fwht_kernel=False)
        torch.cuda.synchronize()
        n_conv = converged_equal(got, plain, MOD_T_MAX)
        bits_out = bitops.msg_vector_to_bits(got[0], params.M, params.K)
        fe = int((bits_out != bits).any(-1).sum())
        parts.append(f"SNR {snr:g}: {n_conv} of {MOD_BATCH} converge on the plain path, "
                     f"decisions and t_final equal there; frame errors {fe}, t_final "
                     f"{int(got[1].min())}-{int(got[1].max())}, launches (K1, K2, K3) "
                     f"{launches[snr]}")
        ys[snr] = (design, y, var)

    design, y, var = ys[MOD_SNRS[-1]]

    def window(kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(MOD_REPS):
            decode_batch(y, design, params, decode, var, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    paths = {"K1": {}, "plain": dict(fwht_kernel=False)}
    best = {k: float("inf") for k in paths}
    for i in range(4):   # alternate: K1, plain, plain, K1, ...
        for name in (list(paths) if i % 2 == 0 else list(paths)[::-1]):
            best[name] = min(best[name], window(paths[name]))
    rate = {k: MOD_BATCH * it * MOD_REPS / v for k, v in best.items()}
    del ys, y

    # real K=2 at the headline's widths: K1, K2 ("2mm") and the plain path
    p2 = SparcParams(**K2MOD)
    d2 = SparcDesign.for_params(p2, K2MOD_VAR, seed=SEED, device=dev)
    shape2 = (K2MOD_BATCH, d2.E, d2.idx.shape[1], d2.w.bit_length() - 1)
    if (shape2, d2.offset, d2.tall) != (K2MOD_SRHT, 0, False):
        raise AssertionError(f"the K=2 design is {shape2} offset {d2.offset}")
    beta0, y2 = sc_inputs(d2, p2, K2MOD_BATCH, dev, K2MOD_VAR)
    out2, counts2 = {}, {}
    for name, kw in (("K1", {}), ("K2", dict(fwht_mode="2mm")),
                     ("plain", dict(fwht_kernel=False))):
        wht_cuda.LAUNCHES = wht_cuda.LAUNCHES_2MM = denoiser_cuda.LAUNCHES = 0
        out2[name] = decode_batch(y2, d2, p2, decode, K2MOD_VAR, **kw)
        torch.cuda.synchronize()
        counts2[name] = (wht_cuda.LAUNCHES, wht_cuda.LAUNCHES_2MM, denoiser_cuda.LAUNCHES)
    want2 = {"K1": (2 * it - 1, 0, 0), "K2": (0, 2 * it - 1, 0), "plain": (0, 0, 0)}
    if counts2 != want2:
        raise AssertionError(f"K=2 launches (K1, K2, K3) {counts2}, expected {want2}")
    conv2 = {n: converged_equal(out2[n], out2["plain"], MOD_T_MAX) for n in ("K1", "K2")}
    sec2 = {n: int((b != beta0).reshape(K2MOD_BATCH, p2.L, -1).any(-1).sum())
            for n, (b, _) in out2.items()}
    del out2, y2, beta0
    k1_t2 = time_k1(K2MOD_SRHT, d2._idx32, d2.signs, ("cluster",), gen, dev)
    k1_text2, k1_err2 = check_fused_srht(K2MOD_SRHT, d2._idx32, d2.signs, gen, dev)
    rows2, E2, k2_, log_w2 = K2MOD_SRHT
    w2 = 1 << log_w2
    k1_bound2 = least_ms(4 * (w2 + k2_) * (rows2 + E2), rows2 * w2 * log_w2)
    x = torch.randn(rows2, w2, generator=gen, device=dev)
    k2_err, k2_ms = 0.0, {}
    for pre in (True, False):
        got = wht_cuda.fwht_signed_2mm(x, d2.signs, pre)
        want = wht_cuda.fwht_signed_2mm_ref(x, d2.signs, pre)
        torch.cuda.synchronize()
        rel = float((got - want).norm() / want.norm())
        if not rel <= K2_REL_BOUND:
            raise AssertionError(f"K2 at ({rows2}, 2^{log_w2}) pre={pre}: relative "
                                 f"error {rel} > {K2_REL_BOUND}")
        k2_err = max(k2_err, float((got - want).abs().max()))
        del got, want
        k2_ms[pre] = (cuda_ms(lambda: wht_cuda.fwht_signed_2mm(x, d2.signs, pre)),
                      cuda_ms(lambda: wht_cuda.fwht_signed_2mm_ref(x, d2.signs, pre),
                              reps=3, warmup=1))
    a, b = wht_cuda.split_ab(w2)
    ha = wht_cuda.hadamard_factor(a, torch.bfloat16, dev)
    hb = wht_cuda.hadamard_factor(b, torch.bfloat16, dev)
    xb = x.reshape(rows2, a, b).to(torch.bfloat16)
    k2_lib = cuda_ms(lambda: ha @ (xb @ hb))
    del x, xb
    k2_bound = least_ms(4 * (2 * rows2 * w2 + E2 * w2), 2 * rows2 * (a * b * b + a * a * b),
                        BF16_FLOPS)

    phase(14, f"modulated decode K=4 PSK L={MOD['L']} M={MOD['M']} R={MOD['R']} "
              f"P={MOD['P']} t_max {MOD_T_MAX}, {MOD_BATCH} codewords (n={design.n} "
              f"complex, LM={design.LM}, w=2^{design.w.bit_length() - 1} offset 0) on "
              f"{card}: " + "; ".join(parts) + f" | modulated_amp_iterations_per_s at SNR "
              f"{MOD_SNRS[-1]:g}: K1 path {rate['K1']:.1f} (best window {best['K1']:.4f} "
              f"s), plain path {rate['plain']:.1f} (best window {best['plain']:.4f} s) | "
              f"K1 at {MOD_SRHT}: {k1_text}; ms: "
              + ", ".join(f"{k} {v:.5f}" for k, v in k1_t.items())
              + f"; bound {k1_bound['bound_ms']:.5f} ms by {k1_bound['bound_by']} | real "
              f"K=2 L={K2MOD['L']} M={K2MOD['M']} R={K2MOD['R']}, {K2MOD_BATCH} codewords, "
              f"awgn_var {K2MOD_VAR}: launches (K1, K2, K3) {counts2}, converged and equal "
              f"to plain {conv2}, section errors {sec2} | K1 at {K2MOD_SRHT}: {k1_text2}; "
              f"ms: " + ", ".join(f"{k} {v:.5f}" for k, v in k1_t2.items())
              + f"; bound {k1_bound2['bound_ms']:.5f} ms by {k1_bound2['bound_by']} | K2 at "
              f"({rows2}, 2^{log_w2}) pre / post {k2_ms[True][0]:.4f} / "
              f"{k2_ms[False][0]:.4f} ms (plain {k2_ms[True][1]:.4f} / "
              f"{k2_ms[False][1]:.4f} ms; bound {k2_bound['bound_ms']:.4f} ms by "
              f"{k2_bound['bound_by']}; cuBLAS bf16 pair {k2_lib:.4f} ms)")

    common = {"route": "cuda", "source": "ldpc_sparc_tpu_torch/csrc/fwht_signed.cu",
              "replaces": "ldpc_sparc_tpu/ops/wht_pallas.py:138", "library_ms": None}
    return [{"name": "fwht_signed (modulated K=4 decode)", **common,
             "launches": launches[MOD_SNRS[0]][0], "max_abs_err": k1_err,
             "ms": (k1_t["scatter"] + k1_t["gather"]) / 2,
             "plain_ms": (k1_t["scatter plain"] + k1_t["gather plain"]) / 2, **k1_bound},
            {"name": "fwht_signed (K=2 decode)", **common,
             "launches": counts2["K1"][0], "max_abs_err": k1_err2,
             "ms": (k1_t2["scatter"] + k1_t2["gather"]) / 2,
             "plain_ms": (k1_t2["scatter plain"] + k1_t2["gather plain"]) / 2, **k1_bound2},
            {"name": "fwht_signed_2mm (K=2 decode)", "route": "cuda",
             "source": "ldpc_sparc_tpu_torch/csrc/fwht_2mm.cu",
             "replaces": "ldpc_sparc_tpu/ops/wht_pallas.py:103",
             "launches": counts2["K2"][1], "max_abs_err": k2_err,
             "ms": (k2_ms[True][0] + k2_ms[False][0]) / 2,
             "plain_ms": (k2_ms[True][1] + k2_ms[False][1]) / 2, **k2_bound,
             "library_ms": k2_lib}]


def sweeps_and_campaign(dev, card):
    """Phases 15 and 16: the Monte Carlos held to the committed artifacts."""
    import contextlib
    import io
    import os
    import tempfile
    import torch
    from ldpc_sparc_tpu_torch import artifacts, cli, sparc_se
    from ldpc_sparc_tpu_torch.ops import bp_cuda

    # -- 15: sparc-sweep --modulated, both engines, resumed; the K=1 sweeps ------
    def sweep(out, engine, snr, trials):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            [row] = cli.main(MOD_SWEEP + ["--snr-start", str(snr), "--snr-stop", str(snr),
                                          "--trials", str(trials), "--design-engine",
                                          engine, "--out", out])
        return row, buf.getvalue()

    table, se_text, times = [], [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for again in (False, True):
            t0 = time.perf_counter()
            for engine, (name, snrs, trials, keys) in MOD_SWEEP_ROWS.items():
                rows = []
                for snr in snrs:
                    row, printed = sweep(tmp, engine, snr, trials)
                    if again != (not printed.strip()):
                        raise AssertionError(f"sparc-sweep {engine} SNR {snr}: printed "
                                             f"{printed!r} on {'the rerun' if again else 'the first run'}")
                    rows.append(row)
                if again:
                    continue
                for c in artifacts.compare_sweep(name, rows, keys):
                    if not c["ok"]:
                        raise AssertionError(f"sparc-sweep {engine} against {name}: {c}")
                    table.append(f"{engine} SNR {c['snr']:g} {c['key']} {c['port']:.6g} "
                                 f"(artifact {c['artifact']:.6g}, bound {c['bound']:.3g})")
            times[again] = time.perf_counter() - t0
        with open(os.path.join(tmp, "sparc_sweep.jsonl")) as f:
            n_lines = sum(1 for ln in f if ln.strip())
    if n_lines != sum(len(v[1]) for v in MOD_SWEEP_ROWS.values()):
        raise AssertionError(f"the sweep store holds {n_lines} rows")
    params, _, art = artifacts.sweep_config("modulated_sweep.json")
    for r in art:
        if r["snr"] in MOD_SWEEP_ROWS["srht"][1]:
            psi, _ = sparc_se(r["awgn_var"], params, MOD_SE_T_MAX, MOD_SE_SAMPLES,
                              seed=SEED, device=dev)
            se_text.append(f"SNR {r['snr']:g} {float(psi[-1].mean()):.4g} (artifact "
                           f"{r['se_psi_final']:.4g})")
    k1_table, t0 = [], time.perf_counter()
    for name, snrs in artifacts.K1_SWEEP_ROWS.items():
        rows = artifacts.run_sweep_rows(name, snrs, device=dev)
        for c in artifacts.compare_sweep(name, rows):
            if not c["ok"]:
                raise AssertionError(f"sparc_ber_sweep against {name}: {c}")
            k1_table.append(f"{name.split('_')[0]} SNR {c['snr']:g} {c['key']} "
                            f"{c['port']:.6g} ({c['artifact']:.6g}, {c['bound']:.3g})")
    dt_k1 = time.perf_counter() - t0
    phase(15, f"sparc-sweep --modulated --K 4 --L 2048 --M 8 --R 2.6 --t-max {MOD_T_MAX} on "
              f"{card}: srht at SNR {MOD_SWEEP_ROWS['srht'][1]} x "
              f"{MOD_SWEEP_ROWS['srht'][2]} trials, dft at {MOD_SWEEP_ROWS['dft'][1]} x "
              f"{MOD_SWEEP_ROWS['dft'][2]}: {times[False]:.1f} s, rerun into the same --out "
              f"{times[True]:.1f} s decoding nothing | within the two-sample bound of "
              f"modulated_sweep.json and oracle_parity_mod_dft.json's jax side: "
              + "; ".join(table) + " | sparc_se final psi: " + ", ".join(se_text)
              + f" | sparc_ber_sweep at the K=1 artifacts' configurations and counts "
              f"({dt_k1:.1f} s), port (artifact, bound): " + "; ".join(k1_table))

    # -- 16: the campaign's per-point counter against campaign_tpu.json ----------
    cfg = artifacts.campaign_config(artifacts.CAMPAIGN_SIM_ID)
    parts = []
    for snr in artifacts.CAMPAIGN_SNRS:
        bp_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        rec = artifacts.run_campaign_point(cfg, snr, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if bp_cuda.LAUNCHES != rec[5] // cfg["protocol"]["batch"] or \
                rec[6] < cfg["protocol"]["min_errors"]:
            raise AssertionError(f"campaign point {rec}: {bp_cuda.LAUNCHES} K4 launches")
        checks = artifacts.compare_campaign_point(cfg, rec)
        if len(checks) < 2 or not all(c["ok"] for c in checks):
            raise AssertionError(f"campaign point at {snr} dB: {checks}")
        parts.append(f"{snr:.3f} dB: BER {rec[8] / rec[7]:.4e} ({rec[6]} block errors in "
                     f"{rec[5]} blocks, {bp_cuda.LAUNCHES} K4 launches, {dt:.2f} s) against "
                     + ", ".join(f"{c['against']} {c['snr']:.3f} dB {c['artifact']:.4e} "
                                 f"(bound {c['bound']:.3g})" for c in checks))
    phase(16, f"campaign {cfg['standard']} r={cfg['rate']} z={cfg['z']} {cfg['ptype']} "
              f"(campaign_tpu.json sim_id {cfg['sim_id']}), batch "
              f"{cfg['protocol']['batch']}, {cfg['protocol']['dectype']}, <= "
              f"{cfg['protocol']['max_iters']} iterations, >= "
              f"{cfg['protocol']['min_errors']} block errors, on {card}: " + "; ".join(parts))


def slice_f(dev, card):
    """Phases 17-19: the oracle, the campaign CLI and the mesh."""
    import contextlib
    import io
    import math
    import os
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from ldpc_sparc_tpu_torch import (DecodeParams, SparcDesign, SparcParams, artifacts,
                                      cli, concat_mc_trial_errors, get_code)
    from ldpc_sparc_tpu_torch.io.results import results_txt_to_csv
    from ldpc_sparc_tpu_torch.models.sparc import decode_batch
    from ldpc_sparc_tpu_torch.ops import bp_cuda, denoiser_cuda, wht_cuda
    from ldpc_sparc_tpu_torch.parallel.mesh import make_mesh
    from ldpc_sparc_tpu_torch.parallel.montecarlo import sparc_mc_counts
    from ldpc_sparc_tpu_torch.parallel.sharded import make_sharded_sim_step

    # -- 17: K4 against the float64 C++ oracle ----------------------------------
    code = get_code(*ORACLE_CODE)
    rng = np.random.default_rng(SEED)
    sigma2 = 1.0 / 10 ** (ORACLE_SNR_DB / 10)
    rows = []
    for _ in range(ORACLE_TRIALS):      # per codeword: its bits, then its noise
        x = code.encode(torch.as_tensor(rng.integers(0, 2, code.K))).numpy()
        rows.append(2.0 / sigma2 * ((1.0 - 2.0 * x)
                                    + rng.normal(0, math.sqrt(sigma2), code.N)))
    llr = np.stack(rows)
    llr_t = torch.as_tensor(llr, dtype=torch.float32, device=dev)
    parts = []
    bp_cuda.LAUNCHES = 0
    for dectype in ORACLE_DECTYPES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = code.decode(llr_t, ORACLE_ITERS, dectype)
        torch.cuda.synchronize()
        k4_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = [code.decode_ref(r, ORACLE_ITERS, dectype) for r in llr]
        oracle_s = time.perf_counter() - t0
        its = res.iterations.cpu().numpy()
        dec = (res.app < 0).cpu().numpy()
        bad = [i for i, (app, it) in enumerate(ref)
               if its[i] != it or not np.array_equal(dec[i], app < 0)]
        if bad:
            raise AssertionError(f"K4 {dectype} differs from the float64 oracle on "
                                 f"codewords {bad}: iterations "
                                 f"{[(int(its[i]), ref[i][1]) for i in bad]}")
        parts.append(f"{dectype}: iterations mean/max {float(its.mean()):.2f}/"
                     f"{int(its.max())}, {int((its >= ORACLE_ITERS).sum())} at the cap "
                     f"(K4 decode {k4_s * 1e3:.2f} ms, oracle {oracle_s * 1e3:.1f} ms)")
    launches = bp_cuda.LAUNCHES
    if launches != len(ORACLE_DECTYPES):
        raise AssertionError(f"the oracle check launched K4 {launches} times")
    phase(17, f"K4 vs the port's float64 C++ oracle, {ORACLE_CODE[0]} r={ORACLE_CODE[1]} "
              f"z={ORACLE_CODE[2]} at {ORACLE_SNR_DB:g} dB, <= {ORACLE_ITERS} iterations, "
              f"{ORACLE_TRIALS} codewords each, on {card}: decisions and iterations "
              f"equal on every codeword | K4 launches {launches} | " + "; ".join(parts))

    # -- 18: ldpc-campaign, resumed; results2csv --native; plot-results ----------
    def run_cli(argv):
        out, err = io.StringIO(), io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                got = cli.main(argv)
            except SystemExit as e:
                got = e
        torch.cuda.synchronize()
        return got, out.getvalue(), err.getvalue(), time.perf_counter() - t0

    cfg = artifacts.campaign_config(7)
    with tempfile.TemporaryDirectory() as tmp:
        full, cut = os.path.join(tmp, "full"), os.path.join(tmp, "cut")
        recs, _, err_full, dt_full = run_cli(CAMPAIGN_CLI + ["--out", full])
        with open(os.path.join(full, "ldpc_campaign.jsonl")) as f:
            lines = f.readlines()
        os.makedirs(cut)
        with open(os.path.join(cut, "ldpc_campaign.jsonl"), "w") as f:
            f.writelines(lines[:CAMPAIGN_CUT])
        bp_cuda.LAUNCHES = 0
        recs2, printed, _, dt_resume = run_cli(CAMPAIGN_CLI + ["--out", cut])
        launches_c = bp_cuda.LAUNCHES
        files = {}
        for name in ("ldpc_campaign.jsonl", "results.txt", "results.csv"):
            with open(os.path.join(full, name)) as a, open(os.path.join(cut, name)) as b:
                files[name] = a.read() == b.read()
        resumed = [json.loads(ln)["point"] for ln in printed.splitlines()]
        if not isinstance(recs, list) or len(recs) != 4 or recs2 != recs \
                or not all(files.values()) or resumed != [2, 3]:
            raise AssertionError(f"ldpc-campaign resumed: {recs2} vs {recs}, files "
                                 f"equal {files}, points measured on resume {resumed}")
        # the pipelined loop launches each point's batches and one more, the
        # speculative batch it discards when the point stops
        want = (sum(r[5] for r in recs[CAMPAIGN_CUT:]) // cfg["protocol"]["batch"]
                + len(recs) - CAMPAIGN_CUT)
        if launches_c != want:
            raise AssertionError(f"the resumed campaign launched K4 {launches_c} times, "
                                 f"expected {want}")
        held = []
        for rec in recs:
            for c in artifacts.compare_campaign_point(cfg, rec):
                if not c["ok"]:
                    raise AssertionError(f"campaign point {rec} against {c}")
                held.append(f"{c['snr']:.3f} dB {c['against']}")
        txt = os.path.join(cut, "results.txt")
        native_csv = os.path.join(cut, "native.csv")
        got, _, err, _ = run_cli(["results2csv", txt, native_csv, "--native"])
        with open(native_csv) as f:
            native = f.read()
        if isinstance(got, SystemExit) or native != results_txt_to_csv(txt):
            raise AssertionError(f"results2csv --native differs from the Python "
                                 f"converter: {native!r} {err}")
        figure = os.path.join(cut, "plot.png")
        got, _, err, _ = run_cli(["plot-results", txt, figure])
        if os.path.exists(figure):
            plot = f"plot-results wrote {os.path.getsize(figure)} bytes"
        elif isinstance(got, SystemExit) and "matplotlib" in err:
            plot = f"plot-results: {err.strip()}"
        else:
            raise AssertionError(f"plot-results neither wrote {figure} nor said why: {err}")
        water = (f"waterfall.png {os.path.getsize(os.path.join(full, 'waterfall.png'))} "
                 f"bytes" if os.path.exists(os.path.join(full, "waterfall.png"))
                 else f"stderr: {err_full.strip()}")
    phase(18, f"ldpc-campaign --sim-id 7 ({cfg['standard']} r={cfg['rate']} z={cfg['z']}) "
              f"batch 512 sumprod2 <= 200 iterations >= 100 block errors, 4 points, on "
              f"{card}: {dt_full:.2f} s; the store cut to its first {CAMPAIGN_CUT} points "
              f"and rerun: points {resumed} measured in {dt_resume:.2f} s with "
              f"{launches_c} K4 launches, records, store, results.txt and results.csv "
              f"equal to the uninterrupted run's | SNR "
              + ", ".join(f"{r[4]:.3f} dB {r[6]}/{r[5]}" for r in recs)
              + f" | within campaign_tpu.json's bound: {', '.join(held)} | results2csv "
              f"--native byte-identical to the Python converter ({len(native)} bytes) | "
              f"{plot} | ldpc-campaign's {water}")

    # -- 19: the mesh on the card ------------------------------------------------
    mesh = make_mesh()
    try:
        head, dec = SparcParams(P=P, R=R, L=L, M=M), DecodeParams(t_max=T_MAX)
        wht_cuda.LAUNCHES = denoiser_cuda.LAUNCHES = 0
        mc = sparc_mc_counts(head, dec, AWGN_VAR, SEED, MESH_TRIALS, mesh=mesh)
        torch.cuda.synchronize()
        l_mc = (wht_cuda.LAUNCHES, denoiser_cuda.LAUNCHES)
        if mc != sparc_mc_counts(head, dec, AWGN_VAR, SEED, MESH_TRIALS, device=dev) \
                or min(l_mc) == 0:
            raise AssertionError(f"sparc_mc_counts on a mesh of one: {mc}, launches "
                                 f"(K1, K3) {l_mc}")
        sp, ldpc, lengths, dp_, awgn = concat_problem()
        wht_cuda.LAUNCHES = bp_cuda.LAUNCHES = 0
        e_mesh = concat_mc_trial_errors(sp, ldpc, lengths, True, dp_, awgn, CONCAT_SEED,
                                        CONCAT_TRIALS, CONCAT_DECODER, mesh=mesh)
        l_c = (wht_cuda.LAUNCHES, bp_cuda.LAUNCHES)
        e_one = concat_mc_trial_errors(sp, ldpc, lengths, True, dp_, awgn, CONCAT_SEED,
                                       CONCAT_TRIALS, CONCAT_DECODER, device=dev)
        if not np.array_equal(e_mesh, e_one) or min(l_c) == 0:
            raise AssertionError(f"concat_mc_trial_errors on a mesh of one: {e_mesh} vs "
                                 f"{e_one}, launches (K1, K4) {l_c}")
        sc, dsc = SparcParams(**SC), DecodeParams(t_max=SC_T_MAX)
        t0 = time.perf_counter()
        step, _ = make_sharded_sim_step(sc, dsc, SC_AWGN, mesh, seed=SEED)
        build_s = time.perf_counter() - t0
        seeds = [(SEED, t) for t in range(SC_BATCH)]
        step(seeds)
        torch.cuda.synchronize()
        wht_cuda.LAUNCHES = denoiser_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        c11 = step(seeds)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        l_s = (wht_cuda.LAUNCHES, denoiser_cuda.LAUNCHES)
        it = SC_T_MAX - 1
        if l_s != (2 * it, it):
            raise AssertionError(f"the sharded step launched (K1, K3) {l_s}, expected "
                                 f"{(2 * it, it)}")
        design = SparcDesign.for_params(sc, SC_AWGN, seed=SEED, device=dev)
        beta0, y = sc_inputs(design, sc, SC_BATCH, dev)
        bs, ts = step.decode(y)
        bu, tu = decode_batch(y, design, sc, dsc, SC_AWGN)
        conv = tu < it
        if int(conv.sum()) == 0 or not torch.equal(bs[conv], bu[conv]) or \
                int((ts - tu).abs().max()) > 1:
            raise AssertionError(f"sharded decode vs decode_batch: t_final "
                                 f"{ts.tolist()} vs {tu.tolist()}")
        del y, beta0, bs, bu, step
    finally:
        dist.destroy_process_group()
    cmd = [sys.executable, "-m", "ldpc_sparc_tpu_torch.parallel.multiproc_mc",
           "--nprocs", "2", "--sec", "2", "--sharded", "--backend", "gloo",
           "--P", str(SC["P"]), "--R", str(SC["R"]), "--L", str(SC["L"]),
           "--M", str(SC["M"]), "--omega", str(SC["omega"]), "--Lambda", str(SC["Lambda"]),
           "--t-max", str(SC_T_MAX), "--trials", str(SC_BATCH), "--awgn-var", str(SC_AWGN),
           "--seed", str(SEED), "--no-reference"]
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, env=env)
    dt12 = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the sharded step on two ranks failed:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    r12 = json.loads(proc.stdout.strip().splitlines()[-1])
    if r12["counts"] != c11 or r12["mesh"] != [1, 2] or \
            min(r12["launches"].values()) == 0:
        raise AssertionError(f"the sharded step at (1,2): {r12} against (1,1) {c11}")
    phase(19, f"mesh on {card}: a world of one (NCCL): sparc_mc_counts L={L} M={M} R={R} "
              f"{MESH_TRIALS} trials {mc} equal to mesh=None (launches K1, K3 {l_mc}); "
              f"concat_mc_trial_errors z=150 {CONCAT_TRIALS} trials {CONCAT_DECODER} "
              f"per-trial errors {e_mesh.tolist()} equal to mesh=None (launches K1, K4 "
              f"{l_c}) | section-sharded step, SC L={SC['L']} M={SC['M']} "
              f"omega={SC['omega']} Lambda={SC['Lambda']} R={SC['R']} t_max {SC_T_MAX}, "
              f"{SC_BATCH} codewords: (1,1) {c11}, step {step_s:.4f} s (design build "
              f"{build_s:.2f} s), launches (K1, K3) {l_s}; decode(y) vs decode_batch: "
              f"decisions equal on the {int(conv.sum())} converged, t_final within 1 | "
              f"(1,2), two ranks on this card, {r12['backend']}: {r12['counts']}, equal; "
              f"step {r12['seconds']:.4f} s, rank 0's launches {r12['launches']} "
              f"({dt12:.1f} s with start-up)")


def slice_g(dev, card):
    """Phases 20-22; returns the kernels line's rows for K2 with float32
    operands (at path A's shape) and K3 at M = 8192 (path C's)."""
    import contextlib
    import io
    import os
    import tempfile
    import torch
    from ldpc_sparc_tpu_torch import DecodeParams, SparcDesign, SparcParams, artifacts, cli
    from ldpc_sparc_tpu_torch.examples import concat_probes, sc_decode_wave, sparc_demo
    from ldpc_sparc_tpu_torch.models.sparc import awgn_channel, decode_batch
    from ldpc_sparc_tpu_torch.ops import bp_cuda, denoiser_cuda, wht_cuda
    from ldpc_sparc_tpu_torch.utils import bits as bitops
    from ldpc_sparc_tpu_torch.utils.metrics import bit_error_rate

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def zero():
        wht_cuda.LAUNCHES = wht_cuda.LAUNCHES_2MM = denoiser_cuda.LAUNCHES = 0

    def launches():
        torch.cuda.synchronize()
        return wht_cuda.LAUNCHES, wht_cuda.LAUNCHES_2MM, denoiser_cuda.LAUNCHES

    def drive(paths, y, design, params, decode, awgn_var):
        """Each path's decode of y with the counts zeroed before it and read
        after it: ({name: (beta, t_final)}, {name: (K1, K2, K3)})."""
        out, counts = {}, {}
        for name, kw in paths.items():
            zero()
            out[name] = decode_batch(y, design, params, decode, awgn_var, **kw)
            counts[name] = launches()
        return out, counts

    def rates(paths, y, design, params, decode, awgn_var):
        """AMP iterations/s of each path, counted as phase 5 counts them:
        batch (t_max - 1) PATH_REPS over the best of PATH_WINDOWS windows,
        the paths in turns."""
        best = {k: float("inf") for k in paths}
        for i in range(PATH_WINDOWS):
            for name in (list(paths) if i % 2 == 0 else list(paths)[::-1]):
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(PATH_REPS):
                    decode_batch(y, design, params, decode, awgn_var, **paths[name])
                torch.cuda.synchronize()
                best[name] = min(best[name], time.perf_counter() - t)
        n = y.shape[0] * (decode.t_max - 1) * PATH_REPS
        return {k: (n / v, v) for k, v in best.items()}

    def gate(out, beta0, batch, L_):
        """Section errors of each path; the kernel paths' decisions equal to
        the plain path's and t_final within 1 of it."""
        errs = {}
        for name, (beta, _) in out.items():
            if beta.shape != beta0.shape or not bool(torch.isfinite(beta).all()):
                raise AssertionError(f"{name}: wrong shape or not finite")
            errs[name] = int((beta != beta0).reshape(batch, L_, -1).any(-1).sum())
        bp, tp = out["plain"]
        for name, (beta, t) in out.items():
            if not torch.equal(beta, bp):
                raise AssertionError(f"{name} and plain decisions differ")
            if int((t - tp).abs().max()) > 1:
                raise AssertionError(f"{name}: t_final differs by more than 1")
        return errs

    # -- 20: K2 with float32 operands ---------------------------------------------
    # the table's kernel (wgmma from 2^12, the mma.sync pass kernels below)
    # and the pass kernels by name: each bit-exact on ternary rows
    exact = []
    for log_w in K2F32_TERNARY_LOG_W:
        w = 1 << log_w
        x = torch.randint(-1, 2, (4, w), generator=gen, device=dev).float()
        signs = (torch.randint(0, 2, (2, w), generator=gen, device=dev) * 2 - 1).float()
        kernels = (("wgmma",) if log_w >= wht_cuda.WGMMA_MIN_LOG_W else ()) + ("mma",)
        for sg, pre in ((signs, True), (signs, False), (None, True)):
            want = wht_cuda.fwht_signed_ref(x, sg, pre)
            for kernel in kernels:
                got = wht_cuda.fwht_signed_2mm(x, sg, pre, "float32", kernel=kernel)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"K2 float32 ({kernel}) on ternary rows at 2^{log_w} "
                                         f"pre={pre} signs={sg is not None} is not exact")
        exact.append(f"2^{log_w} ({', '.join(kernels)})")
    sc_params = SparcParams(**SC)
    sc_design = SparcDesign.for_params(sc_params, SC_AWGN, seed=SEED, device=dev)
    head_signs = (torch.randint(0, 2, (1, 1 << 19), generator=gen, device=dev) * 2
                  - 1).float()
    f32, f32_text = {}, []
    for name, rows, signs in (("SC", SC_BATCH * sc_design.E, sc_design.signs),
                              ("headline", BATCH, head_signs)):
        w = signs.shape[1]
        log_w = w.bit_length() - 1
        a, b = wht_cuda.split_ab(w)
        x = torch.randn(rows, w, generator=gen, device=dev)
        err = {"wgmma": 0.0, "mma": 0.0}
        for pre in (True, False):
            want = wht_cuda.fwht_signed_2mm_ref(x, signs, pre, "float32")
            lim = K2F32_ABS_BOUND * float(want.abs().max())
            for kernel in err:
                got = wht_cuda.fwht_signed_2mm(x, signs, pre, "float32", kernel=kernel)
                torch.cuda.synchronize()
                e = float((got - want).abs().max())
                del got
                if not e <= lim:
                    raise AssertionError(f"K2 float32 ({kernel}) vs plain at {name} "
                                         f"pre={pre}: {e} > {lim}")
                err[kernel] = max(err[kernel], e)
            del want
        # the wgmma kernel, the mma.sync pass kernels and the cuBLAS float32
        # pair in turns, then in the reverse order; the two launches of each
        # kernel that makes two, singly
        ha = wht_cuda.hadamard_factor(a, torch.float32, dev)
        hb = wht_cuda.hadamard_factor(b, torch.float32, dev)
        xv = x.reshape(rows, a, b)
        ms = {(k, pre): [] for k in err for pre in (True, False)}
        lib = []
        for turn in (("wgmma", "mma", "cublas"), ("cublas", "mma", "wgmma")):
            for kernel in turn:
                if kernel == "cublas":
                    lib.append(cuda_ms(lambda: ha @ (xv @ hb), reps=5))
                    continue
                for pre in (True, False):
                    ms[kernel, pre].append(cuda_ms(
                        lambda: wht_cuda.fwht_signed_2mm(x, signs, pre, "float32",
                                                         kernel=kernel), reps=10))
        ms = {k: sum(v) / len(v) for k, v in ms.items()}
        launches_ms = {k: [cuda_ms(lambda: wht_cuda.fwht_signed_2mm(
            x, signs, True, "float32", kernel=k, passes=p), reps=10) for p in (1, 2)]
            for k in err if k == "mma" or log_w > wht_cuda.TILE_MAX_LOG_W_2MM}
        plain = [cuda_ms(lambda: wht_cuda.fwht_signed_2mm_ref(x, signs, pre, "float32"),
                         reps=2, warmup=1) for pre in (True, False)]
        del x, xv
        # the transform's own work: x and y once, the signs once; w log2 w
        # float32 adds a row. Beside it, the earlier reckoning: three full bf16
        # products (one a plane) at the tensor cores' rate
        n_bytes = 4 * (2 * rows * w + signs.shape[0] * w)
        bound = least_ms(n_bytes, rows * w * log_w)
        bound3 = least_ms(n_bytes, 3 * 2 * rows * (a * b * b + a * a * b), BF16_FLOPS)
        lib_ms = sum(lib) / len(lib)
        f32[name] = dict(err=err["wgmma"], ms=(ms["wgmma", True] + ms["wgmma", False]) / 2,
                         plain_ms=sum(plain) / 2, lib=lib_ms, bound=bound)
        f32_text.append(
            f"{name} ({rows}, 2^{log_w}): max|d| wgmma {err['wgmma']:.2e}, mma "
            f"{err['mma']:.2e}; pre / post wgmma {ms['wgmma', True]:.4f} / "
            f"{ms['wgmma', False]:.4f} ms, mma.sync passes {ms['mma', True]:.4f} / "
            f"{ms['mma', False]:.4f} ms ("
            + ", ".join(f"{k} launch 1 {v[0]:.4f}, launch 2 {v[1]:.4f}"
                        for k, v in launches_ms.items())
            + f"), plain {plain[0]:.4f} / {plain[1]:.4f} ms, cuBLAS float32 pair "
            f"{lib_ms:.4f} ms ({' / '.join(f'{v:.4f}' for v in lib)}), bound "
            f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} (three bf16 products: "
            f"{bound3['bound_ms']:.4f} ms by {bound3['bound_by']})")

    # path A: the SC decode through K2 with float32 operands
    decode = DecodeParams(t_max=SC_T_MAX)
    beta0, y = sc_inputs(sc_design, sc_params, SC_BATCH, dev)
    paths = {"K1+K3": {}, "K2+K3": dict(fwht_mode="2mm"),
             "K2f32+K3": dict(fwht_mode="2mm_f32"),
             "plain": dict(fused_denoiser=False, fwht_kernel=False)}
    out, counts_a = drive(paths, y, sc_design, sc_params, decode, SC_AWGN)
    it = SC_T_MAX - 1
    if counts_a["K2f32+K3"] != (0, 2 * it - 1, it):
        raise AssertionError(f"path A launches (K1, K2, K3) {counts_a['K2f32+K3']}")
    del out["K2+K3"]   # bf16 operands: held to section errors only, in phase 10
    sec_a = gate(out, beta0, SC_BATCH, sc_params.L)
    if sec_a["plain"] != 0 or sec_a["K2f32+K3"] > sec_a["plain"]:
        raise AssertionError(f"path A section errors {sec_a}")
    tf_a = {k: f"{int(t.min())}-{int(t.max())}" for k, (_, t) in out.items()}
    del paths["plain"]
    rate_a = rates(paths, y, sc_design, sc_params, decode, SC_AWGN)
    del y, beta0, out

    # path B: the headline decode through K2 with float32 operands
    params = SparcParams(P=P, R=R, L=L, M=M)
    decode = DecodeParams(t_max=T_MAX)
    design = SparcDesign.for_params(params, AWGN_VAR, seed=SEED, device=dev)
    g2 = torch.Generator(device=dev).manual_seed(SEED)
    bits = bitops.random_bits(g2, BATCH * params.bit_len).reshape(BATCH, params.bit_len)
    beta0 = bitops.bits_to_msg_vector(bits, M)
    y = awgn_channel(design.ab(beta0), AWGN_VAR, g2)
    paths = {"K1+K3": {}, "K2f32+K3": dict(fwht_mode="2mm_f32"),
             "plain": dict(fused_denoiser=False, fwht_kernel=False)}
    out, counts_b = drive(paths, y, design, params, decode, AWGN_VAR)
    if counts_b["K2f32+K3"] != (0, 2 * (T_MAX - 1) - 1, T_MAX - 1):
        raise AssertionError(f"path B launches (K1, K2, K3) {counts_b['K2f32+K3']}")
    ber_b = float(bit_error_rate(bits, bitops.msg_vector_to_bits(out["K2f32+K3"][0], M))
                  .mean())
    if ber_b != 0.0:
        raise AssertionError(f"path B BER {ber_b}")
    gate(out, beta0, BATCH, L)
    del paths["plain"]
    rate_b = rates(paths, y, design, params, decode, AWGN_VAR)
    del y, beta0, out

    # sparc-sweep --fwht-mode 2mm_f32: path A's code, then sc_sweep.json's rows
    def sweep(flags, out_dir):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rows = cli.main(["sparc-sweep", *flags, "--fwht-mode", "2mm_f32",
                             "--device", "cuda", "--out", out_dir])
        return rows, buf.getvalue()

    sc_cfg, sc_tmax, _ = artifacts.sweep_config(SC_SWEEP_ROWS[0])
    art_flags = ["--P", str(sc_cfg.P), "--R", str(sc_cfg.R), "--L", str(sc_cfg.L),
                 "--M", str(sc_cfg.M), "--spatially-coupled", "--omega", str(sc_cfg.omega),
                 "--Lambda", str(sc_cfg.Lambda), "--t-max", str(sc_tmax), "--trials",
                 str(artifacts.sweep_config(SC_SWEEP_ROWS[0])[2][0]["frames"]),
                 "--num-snrs", "2", "--snr-start", str(SC_SWEEP_ROWS[1][0]),
                 "--snr-stop", str(SC_SWEEP_ROWS[1][1])]
    with tempfile.TemporaryDirectory() as tmp:
        zero()
        t0 = time.perf_counter()
        rows_a, _ = sweep(F32_SWEEP, tmp)
        dt_a, k_a = time.perf_counter() - t0, launches()
        zero()
        t0 = time.perf_counter()
        rows_s, _ = sweep(art_flags, tmp)
        dt_s, k_s = time.perf_counter() - t0, launches()
        again, printed = sweep(art_flags, tmp)
        with open(os.path.join(tmp, "sparc_sweep.jsonl")) as f:
            n_lines = sum(1 for ln in f if ln.strip())
    if printed.strip() or again != rows_s or n_lines != 4:
        raise AssertionError(f"sparc-sweep rerun decoded again: {printed!r}, {n_lines} rows")
    if k_a[1] == 0 or k_s[1] != 0 or k_s[0] == 0:
        raise AssertionError(f"sparc-sweep launches (K1, K2, K3): path A {k_a}, "
                             f"sc_sweep {k_s}")
    rows_a.sort(key=lambda r: r["snr"])
    if not rows_a[1]["ber"] <= rows_a[0]["ber"]:
        raise AssertionError(f"sparc-sweep BER rises with SNR: {rows_a}")
    table = []
    for c in artifacts.compare_sweep(SC_SWEEP_ROWS[0], rows_s):
        if not c["ok"]:
            raise AssertionError(f"sparc-sweep 2mm_f32 against {SC_SWEEP_ROWS[0]}: {c}")
        table.append(f"SNR {c['snr']:g} {c['key']} {c['port']:.6g} (artifact "
                     f"{c['artifact']:.6g}, bound {c['bound']:.3g})")
    phase(20, f"K2 with float32 operands on {card}: bit-exact on ternary rows at "
              f"{', '.join(exact)} (pre, post, no signs); Gaussian rows against plain "
              f"(max|d| <= {K2F32_ABS_BOUND:g} max|ref|): " + "; ".join(f32_text)
              + f" | path A, the SC decode of phase 10 (batch {SC_BATCH}): section errors "
              f"{sec_a}, decisions equal to plain, t_final {tf_a}, launches (K1, K2, K3) "
              f"{counts_a} | sc_amp_iterations_per_s "
              + ", ".join(f"{k} {v[0]:.1f} (best window {v[1]:.4f} s)"
                          for k, v in rate_a.items())
              + f" | path B, the headline through it: BER {ber_b}, decisions equal to plain, "
              f"launches {counts_b['K2f32+K3']}, sparc_amp_iterations_per_s "
              + ", ".join(f"{k} {v[0]:.1f} (best window {v[1]:.4f} s)"
                          for k, v in rate_b.items())
              + f" | sparc-sweep --fwht-mode 2mm_f32 on path A's code, 16 trials: "
              f"{dt_a:.1f} s, launches {k_a}, "
              + ", ".join(f"SNR {r['snr']:g} BER {r['ber']:.3e} FER {r['fer']:.3f}"
                          for r in rows_a)
              + f"; at {SC_SWEEP_ROWS[0]}'s configuration ({dt_s:.1f} s, launches {k_s}, "
              f"rerun decoding nothing): " + "; ".join(table))

    # -- 21: K3 at sections of 8192 and more ---------------------------------------
    # every route that takes M against the plain version, each run twice (the
    # same bits), then the routes timed in turns on the same inputs
    k3, k3_text = {}, []
    for Bk, Lk, Mk in K3_LONG_SHAPES:
        beta = torch.softmax(3 * torch.randn(Bk, Lk, Mk, generator=gen, device=dev),
                             -1).reshape(Bk, -1)
        azo = 2 * torch.randn(Bk, Lk * Mk, generator=gen, device=dev)
        tau = 0.5 + 1.5 * torch.rand(Bk, Lk, generator=gen, device=dev)
        want = denoiser_cuda.fused_denoise_update_ref(beta, azo, tau, Mk)
        routes = [r for r in denoiser_cuda.ROUTES
                  if r == "block" or Mk >= denoiser_cuda.CLUSTER_MIN_M]
        errs = []
        for route in routes:
            got = denoiser_cuda.fused_denoise_update(beta, azo, tau, Mk, route)
            again = denoiser_cuda.fused_denoise_update(beta, azo, tau, Mk, route)
            torch.cuda.synchronize()
            if not all(torch.equal(g, a_) for g, a_ in zip(got, again)):
                raise AssertionError(f"K3 {route} at ({Bk}, {Lk}, {Mk}): two runs differ")
            for key, g, w_ in zip(DENOISE_TOL, got, want):
                torch.testing.assert_close(g, w_, rtol=DENOISE_TOL[key][0],
                                           atol=DENOISE_TOL[key][1] if key == "s"
                                           else K3_LONG_ATOL)
                errs.append(float((g - w_).abs().max()))
            del got, again
        del want
        n = Bk * Lk * Mk
        ms = {r: float("inf") for r in routes}
        for turn in (routes, routes[::-1]):
            for r in turn:
                ms[r] = min(ms[r], cuda_ms(lambda: denoiser_cuda.fused_denoise_update(
                    beta, azo, tau, Mk, r)))
        k3[Mk] = dict(err=max(errs), ms=ms,
                      plain_ms=cuda_ms(lambda: denoiser_cuda.fused_denoise_update_ref(
                          beta, azo, tau, Mk), reps=3),
                      bound=least_ms(4 * (4 * n + 2 * Bk * Lk), 8 * n))
        bound = k3[Mk]["bound"]["bound_ms"]
        k3_text.append(f"({Bk}, {Lk}, 2^{Mk.bit_length() - 1}): max|d| {k3[Mk]['err']:.2e}, "
                       + ", ".join(f"{r} {v:.4f} ms ({100 * bound / v:.0f} %)"
                                   for r, v in ms.items())
                       + f" (default {denoiser_cuda.k3_route(Mk)}; plain "
                       f"{k3[Mk]['plain_ms']:.4f} ms, bound {bound:.4f} ms by "
                       f"{k3[Mk]['bound']['bound_by']})")
        del beta, azo, tau

    # path C: L=64, M=8192 through K1 and K3
    params = SparcParams(**PATH_C)
    design = SparcDesign.for_params(params, AWGN_VAR, seed=SEED, device=dev)
    g2 = torch.Generator(device=dev).manual_seed(SEED)
    bits = bitops.random_bits(g2, BATCH * params.bit_len).reshape(BATCH, params.bit_len)
    beta0 = bitops.bits_to_msg_vector(bits, params.M)
    y = awgn_channel(design.ab(beta0), AWGN_VAR, g2)
    paths = {"K1+K3": {}, "plain": dict(fused_denoiser=False, fwht_kernel=False)}
    out, counts_c = drive(paths, y, design, params, decode, AWGN_VAR)
    if counts_c["K1+K3"] != (2 * (T_MAX - 1) - 1, 0, T_MAX - 1):
        raise AssertionError(f"path C launches (K1, K2, K3) {counts_c['K1+K3']}")
    ber_c = {k: float(bit_error_rate(bits, bitops.msg_vector_to_bits(b, params.M)).mean())
             for k, (b, _) in out.items()}
    if any(v != 0.0 for v in ber_c.values()):
        raise AssertionError(f"path C BER {ber_c}")
    gate(out, beta0, BATCH, params.L)
    tf_c = {k: f"{int(t.min())}-{int(t.max())}" for k, (_, t) in out.items()}
    rate_c = rates(paths, y, design, params, decode, AWGN_VAR)
    del y, beta0, out

    # path D: L=16, M=2^16 through K1 and K3's cluster route
    params_d = SparcParams(**PATH_D)
    design_d = SparcDesign.for_params(params_d, AWGN_VAR, seed=SEED, device=dev)
    g2 = torch.Generator(device=dev).manual_seed(SEED)
    bits = bitops.random_bits(g2, PATH_D_BATCH * params_d.bit_len).reshape(
        PATH_D_BATCH, params_d.bit_len)
    beta0 = bitops.bits_to_msg_vector(bits, params_d.M)
    y = awgn_channel(design_d.ab(beta0), AWGN_VAR, g2)
    out, counts_d = drive(paths, y, design_d, params_d, decode, AWGN_VAR)
    if counts_d["K1+K3"][1:] != (0, T_MAX - 1) or counts_d["K1+K3"][0] == 0:
        raise AssertionError(f"path D launches (K1, K2, K3) {counts_d['K1+K3']}")
    ber_d = {k: float(bit_error_rate(bits, bitops.msg_vector_to_bits(b, params_d.M)).mean())
             for k, (b, _) in out.items()}
    if any(v != 0.0 for v in ber_d.values()):
        raise AssertionError(f"path D BER {ber_d}")
    gate(out, beta0, PATH_D_BATCH, params_d.L)
    tf_d = {k: f"{int(t.min())}-{int(t.max())}" for k, (_, t) in out.items()}
    rate_d = rates(paths, y, design_d, params_d, decode, AWGN_VAR)
    del y, beta0, out
    phase(21, f"K3 at long sections on {card}, every route against plain (s rtol "
              f"{DENOISE_TOL['s'][0]:g}, beta_new and sec_en rtol "
              f"{DENOISE_TOL['beta_new'][0]:g}, atol {K3_LONG_ATOL:g}; two runs bit-equal), "
              "timed in turns with each route's share of the bound: " + "; ".join(k3_text)
              + f" | path C L={params.L} M={params.M} R={params.R} batch {BATCH} (n "
              f"{design.n}, w 2^{design.w.bit_length() - 1}): BER {ber_c}, decisions equal "
              f"to plain, t_final {tf_c}, launches (K1, K2, K3) {counts_c} | AMP "
              f"iterations/s " + ", ".join(f"{k} {v[0]:.1f} (best window {v[1]:.4f} s)"
                                           for k, v in rate_c.items())
              + f" | path D L={params_d.L} M=2^16 R={params_d.R} batch {PATH_D_BATCH} (n "
              f"{design_d.n}, w 2^{design_d.w.bit_length() - 1}, K3 by the cluster route): "
              f"BER {ber_d}, decisions equal to plain, t_final {tf_d}, launches (K1, K2, K3) "
              f"{counts_d} | AMP iterations/s " + ", ".join(
                  f"{k} {v[0]:.1f} (best window {v[1]:.4f} s)" for k, v in rate_d.items()))

    # -- 22: the examples ----------------------------------------------------------
    name, seeds, snr = PROBES
    with tempfile.TemporaryDirectory() as tmp:
        def example(module, *argv):
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                res = module.main([*argv, "--json", os.path.join(tmp, "r.json"),
                                   "--out", os.path.join(tmp, "f.png")])
            with open(os.path.join(tmp, "r.json")) as f:
                if json.load(f) != json.loads(json.dumps(res)):
                    raise AssertionError(f"{module.__name__} wrote another JSON")
            return res, time.perf_counter() - t0

        demo, dt_demo = example(sparc_demo, "--runs", "1")
        if len(demo["configs"]) != 4 or any(
                len(c["ber"]) != 1 or not 0 <= c["ber"][0] <= 1
                or len(c["nmse"]) != demo["t_max"]
                for c in demo["configs"].values()):
            raise AssertionError(f"sparc_demo: {demo['configs']}")
        zero()
        wave, dt_wave = example(sc_decode_wave, "--reps", "1", "--fwht-mode", "2mm_f32")
        k_wave = launches()
        if k_wave[1] == 0 or k_wave[2] == 0:
            raise AssertionError(f"sc_decode_wave launches (K1, K2, K3) {k_wave}")
        zero()
        bp_cuda.LAUNCHES = 0
        probes, dt_probes = example(concat_probes, "--seeds", str(seeds), "--snr", str(snr))
        k_probes = (launches()[0], bp_cuda.LAUNCHES)
        if 0 in k_probes:
            raise AssertionError(f"concat_probes launches (K1, K4) {k_probes}")
    # the probes need BP: every trial again, through K1 and K4 and plain
    codec, probe_dec = concat_probes.problem(False)
    ubits, awgn = codec.user_bits_len, codec.sparc.P / snr
    differ, apart, errs = 0, 0, {}
    for seed in range(seeds):
        runs = {}
        for decoder in concat_probes.DECODERS:
            ub, k = concat_probes.trial(codec, probe_dec, seed, awgn, decoder, dev)
            _, p = concat_probes.trial(codec, probe_dec, seed, awgn, decoder, dev,
                                       fwht_kernel=False, bp_kernel=False)
            for key in ("pre_bp", "post_bp"):
                differ = max(differ, int((k[key] != p[key]).sum(-1).max()))
                errs[decoder, key] = (errs.get((decoder, key), 0)
                                      + (k[key] != ub).sum(-1).cpu().numpy())
            runs[decoder] = k
        apart += sum(int((runs["naive"][key] != runs["integrated"][key]).sum())
                     for key in ("pre_bp", "post_bp"))
    if differ > PROBE_BITS_DIFFER * ubits:
        raise AssertionError(f"concat_probes through K1 and K4: {differ} of {ubits} user "
                             "bits decided unlike the plain path")
    for (decoder, key), e in errs.items():
        # the example's probes are these trials' error counts
        if [round(v * seeds * ubits) for v in probes["probes"][decoder][key]] != e.tolist():
            raise AssertionError(f"concat_probes {decoder} {key}: the example's probes are "
                                 f"not its trials' error counts {e.tolist()}")
    art = artifacts.load(name)
    if (art["config"]["z"], art["config"]["snr"], art["config"]["seeds"]) != (
            probes["config"]["z"], snr, seeds):
        raise AssertionError(f"{name} is another configuration: {art['config']}")
    n_bits = seeds * probes["config"]["user_bits"]
    probe_text = []
    for dec in concat_probes.DECODERS:
        got, want = probes["probes"][dec], art["probes"][dec]
        bound = artifacts.two_sample_bound(got["pre_bp"][0], n_bits, want["pre_bp"][0],
                                           n_bits)
        if not abs(got["pre_bp"][0] - want["pre_bp"][0]) <= bound:
            raise AssertionError(f"concat_probes {dec}: first pre-BP BER "
                                 f"{got['pre_bp'][0]} against {want['pre_bp'][0]}, bound "
                                 f"{bound}")
        probe_text.append(
            f"{dec}: first pre-BP BER {got['pre_bp'][0]:.5f} (artifact "
            f"{want['pre_bp'][0]:.5f}, bound {bound:.4f}); not gated, pre / post-BP at "
            "iterations 2, 5, 10, 25: " + ", ".join(
                f"{got['pre_bp'][i]:.4f} / {got['post_bp'][i]:.4f} ({want['pre_bp'][i]:.4f}"
                f" / {want['post_bp'][i]:.4f})" for i in (1, 4, 9, 24)))
    phase(22, f"examples on {card}: sparc_demo, one run a family ({dt_demo:.1f} s): "
              + "; ".join(f"{k} BER {v['ber'][0]:.4g} t_final {v['t_final'][0]} "
                          f"({v['wall_s_per_run'][0]:.3f} s)"
                          for k, v in demo["configs"].items())
              + f" | sc_decode_wave L=2048 M=512 through K2 with float32 operands "
              f"({dt_wave:.1f} s): first run {wave['wall_s_first_run']:.3f} s, steady "
              f"{wave['wall_s_steady'][0]:.3f} s, {wave['iterations']} iterations, BER "
              f"{wave['ber']:.3g}, launches (K1, K2, K3) {k_wave} | concat_probes z=150 "
              f"{seeds} seeds snr {snr} ({dt_probes:.1f} s, launches (K1, K4) {k_probes}) "
              f"against {name}: " + "; ".join(probe_text)
              + f" | each trial through K1 and K4 against the plain path: at most {differ} of "
              f"{ubits} user bits decided otherwise at any iteration, before or after BP "
              f"(bound {PROBE_BITS_DIFFER * ubits:g}); naive and integrated apart on {apart} "
              f"of {2 * seeds * probe_dec.t_max * ubits} decisions; post-BP errors at iteration "
              f"{probe_dec.t_max} over the trials: naive {errs['naive', 'post_bp'][-1]}, "
              f"integrated {errs['integrated', 'post_bp'][-1]}")

    return [
        {"name": "fwht_signed_2mm_f32", "route": "cuda",
         "source": "ldpc_sparc_tpu_torch/csrc/fwht_2mm.cu",
         "replaces": "ldpc_sparc_tpu/ops/wht_pallas.py:103",
         "launches": counts_a["K2f32+K3"][1],
         "max_abs_err": max(v["err"] for v in f32.values()),
         "ms": f32["SC"]["ms"], "plain_ms": f32["SC"]["plain_ms"], **f32["SC"]["bound"],
         "library_ms": f32["SC"]["lib"]},
        {"name": "fused_denoise_update_m8192", "route": "cuda",
         "source": "ldpc_sparc_tpu_torch/csrc/denoise_update.cu",
         "replaces": "ldpc_sparc_tpu/ops/denoiser_pallas.py:67",
         "launches": counts_c["K1+K3"][2], "max_abs_err": k3[1 << 13]["err"],
         "ms": k3[1 << 13]["ms"]["block"], "plain_ms": k3[1 << 13]["plain_ms"],
         **k3[1 << 13]["bound"], "library_ms": None},
        # the cluster route at path D's shape, (16, 16, 2^16)
        {"name": "fused_denoise_update_cluster", "route": "cuda",
         "source": "ldpc_sparc_tpu_torch/csrc/denoise_update.cu",
         "replaces": "ldpc_sparc_tpu/ops/denoiser_pallas.py:67",
         "launches": counts_d["K1+K3"][2], "max_abs_err": k3[1 << 16]["err"],
         "ms": k3[1 << 16]["ms"]["cluster"], "plain_ms": k3[1 << 16]["plain_ms"],
         **k3[1 << 16]["bound"], "library_ms": None},
    ]


def holds(dev, card):
    """Phases 23-24: the port held to the two reference results it had not
    been held to on the card, through K4 (and K1)."""
    import tempfile
    from ldpc_sparc_tpu_torch import artifacts
    from ldpc_sparc_tpu_torch.ops import bp_cuda, wht_cuda

    # -- 23: the min-sum waterfalls of minsum_campaign.json -------------------------
    t0 = time.perf_counter()
    text, failed = [], []
    for code in artifacts.MINSUM_CODES:
        cfg = artifacts.minsum_config(*code)
        bp_cuda.LAUNCHES = 0
        recs = [artifacts.run_campaign_point(cfg, p["snr"], device=dev)
                for p in cfg["minsum_points"]]
        n_k4 = bp_cuda.LAUNCHES
        if n_k4 != sum(r[5] for r in recs) // cfg["protocol"]["batch"]:
            raise AssertionError(f"min-sum {code}: {n_k4} K4 launches")
        table = [artifacts.compare_minsum_point(cfg, r) for r in recs]
        held = []
        for point in artifacts.minsum_held_points(cfg):
            [row] = [t for t in table if t["snr"] == point["snr"]]
            held.append(f"{row['snr']:.4f} dB BLER {row['port']:.5f} (artifact "
                        f"{row['artifact']:.5f}, bound {row['bound']:.5f})")
            if not row["ok"]:
                failed.append(f"{code} at {row['snr']} dB: {row}")
        snr = artifacts.snr_at_ber([artifacts.record_point(r) for r in recs])
        want = cfg["snr_at_1e-4_minsum"]
        if snr is None or not abs(snr - want) <= artifacts.MINSUM_SNR_TOL_DB:
            raise AssertionError(f"min-sum {code}: SNR at BER 1e-4 {snr} against {want}")
        text.append(f"{code[0]} r={code[1]}: " + "; ".join(held)
                    + f"; 22 points, {sum(t['ok'] for t in table)} within their BLER bound "
                    f"(not gated), {sum(r[5] for r in recs)} blocks, {n_k4} K4 launches; SNR "
                    f"at BER 1e-4 {snr:.4f} dB (artifact {want:.4f}, |d| "
                    f"{abs(snr - want):.4f} <= {artifacts.MINSUM_SNR_TOL_DB})")
    if failed:
        raise AssertionError("min-sum waterfalls: " + " | ".join(failed))
    phase(23, f"min-sum waterfalls on {card} against {artifacts.MINSUM_ARTIFACT} (batch 512, "
              f"minsum 0.7, <= 200 iterations, >= 100 block errors; cliff and BER-1e-4 points "
              f"gated by the two-sample BLER bound, {time.perf_counter() - t0:.1f} s): "
              + " | ".join(text))

    # -- 24: concat-sweep --semi-protected against concat_sweep_semi.jsonl ------------
    t0 = time.perf_counter()
    text, failed, floors = [], [], {}
    wht_cuda.LAUNCHES = bp_cuda.LAUNCHES = 0
    with tempfile.TemporaryDirectory() as tmp:
        for pp, (cfg, h, art) in sorted(artifacts.semi_configs().items(), reverse=True):
            rows = artifacts.run_semi_rows(pp, f"{tmp}/{pp}", device=dev)
            floors[pp] = {}
            for snr, decoders in artifacts.SEMI_DECODERS.items():
                for d in decoders:
                    key = artifacts.semi_row_key(h, d, snr)
                    got = artifacts.compare_semi_row(rows[key], art[key], cfg["logM"])
                    if snr == artifacts.SEMI_SNRS[1]:
                        floors[pp][d] = got["port"]
                    at_floor = snr == artifacts.SEMI_SNRS[1] and d == "sequential"
                    if not got["ok"] or (at_floor and got["bound"] > artifacts.SEMI_FLOOR_BOUND):
                        failed.append(f"{key}: {got}")
                    text.append(f"{pp} {d} snr {snr:.3f}: {got['port']:.5f} (artifact "
                                f"{got['artifact']:.5f}; bits {got['bit_bound']:.4f}, frames "
                                f"{got['frame_bound']:.4f})")
    launches_h = (wht_cuda.LAUNCHES, bp_cuda.LAUNCHES)
    failed += artifacts.semi_floor_law(floors)
    if failed or 0 in launches_h:
        raise AssertionError(f"semi-protected sweep (launches (K1, K4) {launches_h}): "
                             + " | ".join(failed))
    phase(24, f"concat-sweep --semi-protected on {card} against {artifacts.SEMI_ARTIFACT} "
              f"(802.11n r=5/6 z=81, M=64, R_sparc 0.8, mults 3, 25 runs, the artifact's "
              f"keys; |d| <= max(bits, frames), the sequential floor's <= "
              f"{artifacts.SEMI_FLOOR_BOUND}; {time.perf_counter() - t0:.1f} s, launches "
              f"(K1, K4) {launches_h}): " + "; ".join(text)
              + " | the prefix-floor law on the port's rows holds: sequential floors "
              + " < ".join(f"{floors[pp]['sequential']:.5f}" for pp in sorted(floors, reverse=True))
              + ", naive " + ", ".join(f"{floors[pp]['naive']:.4f}"
                                       for pp in sorted(floors, reverse=True)) + " > 0.1")


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

    k4, lxor_us = slice_b(dev, card)
    k2 = slice_c(dev, card, errs)
    k1_d, k4_d = slice_d(dev, card, lxor_us)
    slice_e_kernels = slice_e(dev, card)
    sweeps_and_campaign(dev, card)
    slice_f(dev, card)
    slice_g_kernels = slice_g(dev, card)
    holds(dev, card)
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
    kernels += [k4, k1_d, k4_d, *slice_e_kernels, *slice_g_kernels]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
