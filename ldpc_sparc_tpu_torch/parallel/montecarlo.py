"""Monte Carlo: the SPARC BER sweep, the concatenated LDPC-SPARC sweep
point and the LDPC waterfall campaign, on one device or over the 'dp' axis
of a mesh.

Counterpart of `ldpc_sparc_tpu/parallel/montecarlo.py`:

* `sparc_mc_counts` / `sparc_ber_sweep`: SPARC encode -> AWGN -> AMP ->
  count trials (the performance_plots sweep), for every family, real or
  complex, K=1 or K-PSK, with either design engine. The JAX package's contract
  holds: trial t draws its bits, then its noise, from one generator seeded
  from `rng.derive(seed, t)`, and uses design (seed, t % n_designs) with
  n_designs = min(8, n_trials). The counters are then a function of
  (seed, trial index) alone, however the trials are grouped: the trials
  of one design decode together, as one `decode_batch` call. A host
  thread draws the designs ahead of their decodes (`_designs_ahead`), and
  each goes to the device without a host sync and is dropped once its
  counts are queued.
* `concat_mc_counts`: the concatenated LDPC-SPARC point under the same
  contract (trial t: user bits then noise from `rng.derive(seed, t)`,
  design (seed, t % n_designs)), all trials decoded as one
  `ConcatCodec.decode_soft` call; it returns the point's counters and each
  trial's errors, BP iterations and tau^2 trajectory, read back in one
  copy. `concat_mc_trial_errors` and `concat_ber_point` (concat-sweep's
  point) return parts of it.
* `ldpc_waterfall_campaign` (`_batch_counts`, `_ldpc_block_counts`): the
  adaptive-SNR protocol of the reference's sim() (ldpc_jossy/py/
  ldpc_awgn.py:60-123) over batches of random codewords, each batch
  encoded, sent as BPSK over AWGN and decoded by one batched BP call.
  Batch `ctr` (the index of its first codeword in the campaign's running
  counter) draws its bits and noise from one `torch.Generator` seeded from
  `rng.derive(seed, ctr)`, so a batch is a function of (seed, ctr) alone,
  which is what makes the pipelined loop, the serial loop and a resumed
  run give identical records.

The streams are not the JAX package's (Threefry cannot be reproduced), so
the two packages' counters agree statistically, not bit for bit.

`mesh=` (a ('dp', 'sec') mesh of `parallel/mesh.py`; every rank of it
makes the same call): the trials are padded to a multiple of the dp axis
and dp rank r takes the r-th contiguous share; padded trials are not
decoded and count nothing. Ranks that differ only in 'sec' repeat the same
share. The counters (and the concatenated path's per-trial outputs) are
summed with `all_reduce` over 'dp', so every rank returns the same result,
and, since a trial is a function of (seed, t) alone, the result of
`mesh=None`. A campaign batch is a function of (seed, ctr): every dp rank
draws the whole batch and decodes its share of the codewords, which K4
decodes one by one, so the records are those of one device; with a mesh
the campaign reads each batch before the next (no pipelining), as the
JAX package does. The mesh's device is the default device of each rank.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import ConcatLengths, DecodeParams, LdpcParams, SparcParams
from ..device import all_reduce, resolve_device
from ..models.concat import ConcatCodec, amp_steps
from ..models.ldpc import LdpcCode, get_code
from ..models.sparc import awgn_channel, decode_batch
from ..ops.bp import bp_decode
from ..ops.transforms import DesignStack, design_class, stack_designs  # noqa: F401
from ..utils import bits as bitops
from ..utils import rng as rngmod
from ..utils import tracing
from ..utils.metrics import location_value_errors
from .mesh import axis, mesh_device


def _share(n: int, mesh):
    """(lo, hi, dp group) of this rank's share of n items (n padded to a
    multiple of the dp axis, whose r-th contiguous part rank r takes);
    (0, n, None) without a mesh."""
    if mesh is None:
        return 0, n, None
    n_dp, r, group = axis(mesh, "dp")
    per = -(-n // n_dp)
    return min(r * per, n), min((r + 1) * per, n), group


def _mesh_device(device, mesh):
    return mesh_device(mesh) if device is None and mesh is not None \
        else resolve_device(device)


# --------------------------------------------------------------------------
# SPARC Monte Carlo
# --------------------------------------------------------------------------

@contextlib.contextmanager
def _designs_ahead(params: SparcParams, awgn_var: float, seed, n_designs: int,
                   engine: str, device: torch.device):
    """`take`, for `take(d)` with d = 0, 1, ... n_designs - 1 in turn: design
    (seed, d) by `engine` on `device`.

    One host thread draws the designs in order (`draw_for_params`, the
    leaves pinned for a card), at most two ahead of the one taken, so that
    design d + 1 is drawn while the card runs design d. `take(d)` waits for
    design d and uploads it without a host sync, inside the span
    `mc.designs`, and counts `mc.designs_built` and `mc.designs_waited` (a
    design not yet drawn when asked for; design 0 always is). A draw's
    error is raised by its `take`. The thread has ended when the block
    exits, however it exits.
    """
    draw = functools.partial(design_class(engine).draw_for_params, params,
                             awgn_var, pin=device.type == "cuda")
    pool = ThreadPoolExecutor(max_workers=1)
    ahead = {d: pool.submit(draw, (seed, d)) for d in range(min(2, n_designs))}

    def take(d: int):
        with tracing.span("mc.designs"):
            drawn = ahead.pop(d)
            waited = d == 0 or not drawn.done()
            design = drawn.result().upload(device)
            del drawn                      # its host leaves, before the next draw
            if d + 2 < n_designs:
                ahead[d + 2] = pool.submit(draw, (seed, d + 2))
        tracing.count("mc.designs_built")
        tracing.count("mc.designs_waited", int(waited))
        return design

    try:
        yield take
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def sparc_mc_counts(params: SparcParams, decode: DecodeParams, awgn_var: float,
                    seed, n_trials: int, n_designs: int | None = None,
                    engine: str = "srht", fwht_mode: str = "ms",
                    device=None, fused_denoiser: bool | None = None,
                    mesh=None) -> dict:
    """Run n_trials independent SPARC encode -> AWGN -> AMP -> count trials.

    Trial t: bits then noise from `root_generator(derive(seed, t))`, design
    (seed, t % n_designs) by `engine` ('srht' or 'dft'). The trials of one
    design decode together, as one `decode_batch` call, in design order;
    design d + 1 is drawn on a host thread while design d decodes, and at
    most two designs are held on the device. fused_denoiser: see
    `models.sparc.amp_decode`. mesh: see the module docstring.

    Returns the counters bit_errs, bits, sec_errs, sections, frame_errs,
    frames, iters; a modulated code adds loc_errs and val_errs, and its
    section errors are `location_value_errors`'.
    """
    device = _mesh_device(device, mesh)
    if n_designs is None:
        n_designs = min(8, n_trials)
    lo, hi, group = _share(n_trials, mesh)
    M, K, L = params.M, params.K, params.L
    totals = torch.zeros(6, dtype=torch.int64, device=device)
    with _designs_ahead(params, awgn_var, seed, n_designs, engine,
                        device) as take:
        for d in range(n_designs):
            design = take(d)
            with tracing.span("mc.bits"):
                gens = [rngmod.root_generator(rngmod.derive(seed, t), device)
                        for t in range(d, n_trials, n_designs) if lo <= t < hi]
                if not gens:
                    continue
                bits = torch.stack([bitops.random_bits(g, params.bit_len) for g in gens])
                beta0 = bitops.bits_to_msg_vector(bits, M, K)
            with tracing.span("mc.encode"):
                x = design.ab(beta0, fwht_mode=fwht_mode)
            with tracing.span("mc.noise"):
                y = torch.stack([awgn_channel(xi, awgn_var, g) for xi, g in zip(x, gens)])
            with tracing.span("mc.decode"):
                beta, t_final = decode_batch(y, design, params, decode, awgn_var,
                                             fused_denoiser=fused_denoiser,
                                             fwht_mode=fwht_mode)
            with tracing.span("mc.count"):
                bit_errs = (bitops.msg_vector_to_bits(beta, M, K) != bits).sum(-1)
                if params.modulated:
                    _, (loc_e, val_e, sec_e) = location_value_errors(beta0, beta, L)
                    loc_errs, val_errs = loc_e.sum(), val_e.sum()
                else:
                    sec_e = (beta != beta0).reshape(-1, L, M).any(-1)
                    loc_errs = val_errs = torch.zeros((), dtype=torch.int64, device=device)
                totals += torch.stack([bit_errs.sum(), sec_e.sum(), (bit_errs > 0).sum(),
                                       t_final.sum(), loc_errs, val_errs])
            del design      # its device memory goes to the next upload
    with tracing.span("mc.count"):
        if group is None:
            be, se, fe, it, le, ve = totals.tolist()
            live = it
        else:       # this rank's rows run, beside the sums over 'dp'
            local = totals[3:4].clone()
            all_reduce(totals, group)
            be, se, fe, it, le, ve, live = torch.cat([totals, local]).tolist()
    tracing.count("amp.live_row_iters", live)
    counts = {"bit_errs": be, "bits": n_trials * params.bit_len,
              "sec_errs": se, "sections": n_trials * L,
              "frame_errs": fe, "frames": n_trials, "iters": it}
    if params.modulated:
        counts.update(loc_errs=le, val_errs=ve)
    return counts


def sparc_ber_sweep(params: SparcParams, decode: DecodeParams, awgn_vars, seed,
                    n_trials: int, engine: str = "srht", fwht_mode: str = "ms",
                    device=None, fused_denoiser: bool | None = None,
                    mesh=None) -> list[dict]:
    """BER / SER / FER at each noise level (the performance_plots sweep),
    and LER / VER for a modulated code; point i is seeded (seed, i)."""
    device = _mesh_device(device, mesh)
    rows = []
    for i, v in enumerate(np.atleast_1d(awgn_vars)):
        c = sparc_mc_counts(params, decode, float(v), (seed, i), n_trials,
                            engine=engine, fwht_mode=fwht_mode, device=device,
                            fused_denoiser=fused_denoiser, mesh=mesh)
        row = {"awgn_var": float(v),
               "ber": c["bit_errs"] / c["bits"],
               "ser": c["sec_errs"] / c["sections"],
               "fer": c["frame_errs"] / c["frames"],
               "avg_iters": c["iters"] / c["frames"],
               **c}
        if params.modulated:
            row["ler"] = c["loc_errs"] / c["sections"]
            row["ver"] = c["val_errs"] / c["sections"]
        rows.append(row)
    return rows


# --------------------------------------------------------------------------
# Concatenated LDPC-SPARC Monte Carlo (the num_of_runs loop of
# performance_plots_general.py:101-118, as one batch)
# --------------------------------------------------------------------------

def concat_mc_designs(codec: ConcatCodec, seed, n_trials: int,
                      n_designs: int | None = None, device=None,
                      first: int = 0) -> DesignStack:
    """The Monte Carlo's designs, one per trial of trials first ..
    first + n_trials - 1: trial t's is (seed, t % n_designs), n_designs =
    min(8, n_trials) by default. The n_designs designs are built once and
    their leaves gathered per trial."""
    device = resolve_device(device)
    if n_designs is None:
        n_designs = min(8, n_trials)
    didx = torch.arange(first, first + n_trials, device=device) % n_designs
    return codec.build_designs(seed, n_designs, device).for_trials(didx)


def concat_mc_transmit(codec: ConcatCodec, designs: DesignStack, awgn_var: float,
                       seed, fwht_kernel: bool = True, first: int = 0):
    """(user_bits (B, user_bits_len) int32, ys (B, n)) of the B = designs.D
    trials first .. first + B - 1: trial t draws its user bits, then its
    noise, from `root_generator(derive(seed, t))`; the bits are LDPC-encoded,
    spread by trial t's design (row t - first of `designs`) and sent over
    AWGN."""
    with tracing.span("mc.bits"):
        gens = [rngmod.root_generator(rngmod.derive(seed, t), designs.device)
                for t in range(first, first + designs.D)]
        user_bits = torch.stack([bitops.random_bits(g, codec.user_bits_len)
                                 for g in gens]).to(torch.int32)
    with tracing.span("mc.encode"):
        _, beta0 = codec.message_vector(user_bits)
        x = designs.ab(beta0 / codec.c_amp, fwht_kernel)
    with tracing.span("mc.noise"):
        ys = torch.stack([awgn_channel(xi, awgn_var, g) for xi, g in zip(x, gens)])
    return user_bits, ys


def concat_mc_counts(sparc_params: SparcParams, ldpc_params: LdpcParams,
                     lengths: ConcatLengths, ldpc_protected: bool,
                     decode_params: DecodeParams, awgn_var: float, seed,
                     n_trials: int, decoder: str = "sequential",
                     n_designs: int | None = None, device=None,
                     fwht_kernel: bool = True, bp_kernel: bool = True,
                     bp_inner_iters: int = 6, bp_final_iters: int = 200,
                     mesh=None) -> dict:
    """One point of n_trials encode -> AWGN -> AMP + BP trials, decoded as
    one `ConcatCodec.decode_soft` call.

    Trial t: user bits then noise from `root_generator(derive(seed, t))`,
    design (seed, t % n_designs), n_designs = min(8, n_trials) by default;
    so each trial's outputs are a function of (seed, t) alone. Returns the
    counters frames, frame_errs, bit_errs and bits (user bits), and per
    trial, as numpy arrays in trial order: `errs` (n_trials,) int64 user-bit
    errors, `bp_iters` (n_trials,) int64 iterations of the decode's BP
    calls summed over the trial's LDPC blocks, and `tau_sqr` (n_trials,
    steps) float32, every AMP step's tau^2 (steps = `amp_steps(decoder,
    t_max)`). All of it comes back in one device-to-host copy. With a mesh,
    dp rank r decodes its share of the trials and the per-trial outputs
    are summed over 'dp' by one all_reduce. The counter
    `concat.bp_codeword_iters` adds this rank's `bp_iters`.
    """
    device = _mesh_device(device, mesh)
    codec = ConcatCodec(sparc_params, ldpc_params, lengths, ldpc_protected)
    if n_designs is None:
        n_designs = min(8, n_trials)
    lo, hi, group = _share(n_trials, mesh)
    # one row a trial: errors, BP iterations, tau^2 of each step; float64
    # holds all three exactly, so one copy brings them back
    rows = torch.zeros(n_trials, 2 + amp_steps(decoder, decode_params.t_max),
                       dtype=torch.float64, device=device)
    if hi > lo:
        with tracing.span("mc.designs"):
            designs = concat_mc_designs(codec, seed, hi - lo, n_designs, device,
                                        first=lo)
        user_bits, ys = concat_mc_transmit(codec, designs, awgn_var, seed,
                                           fwht_kernel, first=lo)
        with tracing.span("mc.decode"):
            got = codec.decode_soft(ys, designs, decode_params, decoder,
                                    bp_inner_iters, bp_final_iters,
                                    fwht_kernel=fwht_kernel, bp_kernel=bp_kernel)
    with tracing.span("mc.count"):
        if hi > lo:
            rows[lo:hi, 0] = (user_bits != got.bits).sum(-1)
            rows[lo:hi, 1] = got.bp_iters
            rows[lo:hi, 2:] = got.tau_sqr
        if group is not None:
            all_reduce(rows, group)
        host = rows.cpu().numpy()
    errs = host[:, 0].astype(np.int64)
    bp_iters = host[:, 1].astype(np.int64)
    tracing.count("concat.bp_codeword_iters", int(bp_iters[lo:hi].sum()))
    return {"frames": int(n_trials), "frame_errs": int((errs > 0).sum()),
            "bit_errs": int(errs.sum()), "bits": int(n_trials * codec.user_bits_len),
            "errs": errs, "bp_iters": bp_iters,
            "tau_sqr": host[:, 2:].astype(np.float32)}


def concat_mc_trial_errors(sparc_params: SparcParams, ldpc_params: LdpcParams,
                           lengths: ConcatLengths, ldpc_protected: bool,
                           decode_params: DecodeParams, awgn_var: float, seed,
                           n_trials: int, decoder: str = "sequential",
                           n_designs: int | None = None, device=None,
                           fwht_kernel: bool = True,
                           bp_kernel: bool = True, mesh=None) -> np.ndarray:
    """Per-trial user-bit error counts of `concat_mc_counts`' point, an
    (n_trials,) int64 numpy array (divide by `ConcatCodec.user_bits_len`
    for the per-run BERs, whose min and max are the reference's error
    bars)."""
    return concat_mc_counts(sparc_params, ldpc_params, lengths, ldpc_protected,
                            decode_params, awgn_var, seed, n_trials, decoder,
                            n_designs, device, fwht_kernel, bp_kernel,
                            mesh=mesh)["errs"]


def concat_ber_point(sparc_params: SparcParams, ldpc_params: LdpcParams,
                     lengths: ConcatLengths, ldpc_protected: bool,
                     decode_params: DecodeParams, awgn_var: float, seed,
                     n_trials: int, decoder: str = "sequential", device=None,
                     fwht_kernel: bool = True, bp_kernel: bool = True,
                     mesh=None) -> dict:
    """One sweep point of `concat_mc_counts`: mean, min and max BER over
    n_trials (the aggregation of performance_plots_general.py:120-126)."""
    c = concat_mc_counts(sparc_params, ldpc_params, lengths, ldpc_protected,
                         decode_params, awgn_var, seed, n_trials, decoder,
                         device=device, fwht_kernel=fwht_kernel,
                         bp_kernel=bp_kernel, mesh=mesh)
    bers = c["errs"] / (c["bits"] // c["frames"])
    return {"ber": float(np.mean(bers)), "ber_min": float(np.min(bers)),
            "ber_max": float(np.max(bers)),
            "frame_errs": c["frame_errs"], "frames": c["frames"],
            "bit_errs": c["bit_errs"], "bits": c["bits"]}


# --------------------------------------------------------------------------
# LDPC waterfall campaign
# --------------------------------------------------------------------------


def _batch_counts(code: LdpcCode, snr_db: float, gen: torch.Generator,
                  batch: int, max_iters: int, dectype: str,
                  bp_kernel: bool, part: slice = slice(None)) -> torch.Tensor:
    """Encode, transmit and decode one batch of random codewords; returns
    (bit_errs, block_errs, iters) summed over the batch, as one (3,) int64
    tensor on the generator's device (one copy to read back). `part`: the
    codewords to decode; the whole batch is drawn all the same."""
    dev = gen.device
    sigma2 = 1.0 / 10 ** (snr_db / 10.0)
    u = torch.randint(0, 2, (batch, code.K), generator=gen, device=dev,
                      dtype=torch.int32)
    noise = torch.randn(batch, code.N, generator=gen, device=dev)[part]
    x = code.encode(u[part])
    y = (1.0 - 2.0 * x.to(torch.float32)) + math.sqrt(sigma2) * noise  # BPSK
    llr = (2.0 / sigma2) * y                      # ch2llr (ldpc_awgn.py:51-53)
    method = "minsum" if dectype == "minsum" else "sumprod"
    res = bp_decode(llr, code.graph, max_iters, method, 0.7, bp_kernel=bp_kernel)
    biterrs = (x != (res.app < 0).to(torch.int32)).sum(1)
    return torch.stack([biterrs.sum(), (biterrs > 0).sum(),
                        res.iterations.sum(dtype=torch.int64)])


def _batch_generator(seed, ctr: int, device) -> torch.Generator:
    return rngmod.root_generator(rngmod.derive(seed, int(ctr)), device)


def _ldpc_block_counts(code: LdpcCode, snr_db: float, seed, ctr: int,
                       batch: int, max_iters: int, dectype: str, device=None,
                       bp_kernel: bool = True, mesh=None):
    """Decode one batch of random codewords at SNR (dB); returns
    (bit_errs, block_errs, iters) summed over trials ctr..ctr+batch, read
    back in one device-to-host copy. With a mesh, dp rank r decodes its
    share of the batch and the counters are summed over 'dp'."""
    lo, hi, group = _share(batch, mesh)
    out = _batch_counts(code, snr_db,
                        _batch_generator(seed, ctr, _mesh_device(device, mesh)),
                        batch, max_iters, dectype, bp_kernel, slice(lo, hi))
    if group is not None:
        all_reduce(out, group)
    be, bl, it = out.tolist()
    return be, bl, it


def ldpc_waterfall_campaign(ldpc_params: LdpcParams, seed: int = 0,
                            n_measurements: int = 24,
                            c_awgn_offset: float = 1.0, p_step: float = 100.0,
                            min_errors: int = 100, max_blocks: int = 400000,
                            batch: int = 128, dectype: str = "sumprod2",
                            max_iters: int = 200, pipelined: bool = True,
                            on_point=None, bp_kernel: bool = True,
                            start_point: int = 0, start_snr=None,
                            start_ctr: int = 0, device=None, mesh=None):
    """Adaptive-SNR BER waterfall measurement (sim(), ldpc_awgn.py:60-123).

    Per SNR point, decodes batches of `batch` random codewords on `device`
    until min_errors block errors (or max_blocks), then steps
    SNR += sqrt(p_step / nblocks) — the reference's heuristic (:116).
    `on_point(record, state)` is called after each measured point; the
    optional trailing `state` is the dict {"point", "next_snr", "ctr"} a
    resume needs (single-arg callbacks get just the record).

    Resume: pass start_point (first unmeasured point index), start_snr (the
    SNR that point should measure at) and start_ctr (the running codeword
    counter) from the state of the last measured point, and the campaign
    continues exactly where the interrupted run stopped.

    pipelined: dispatch the next batch before reading the current one's
    counters (on a card the read is an asynchronous copy into pinned memory
    and an event, so the next batch is queued before the host waits).
    False reads each batch before the next is made. Both give identical
    records.

    Returns the list of NEWLY measured records in the reference's 10-field
    tuple schema (standard, rate, z, ptype, SNR, nblocks, nblockerrors,
    nbits, nbiterrors, niters) — the data/results.txt:1 format.
    """
    code = get_code(ldpc_params.standard, ldpc_params.rate, ldpc_params.z,
                    ldpc_params.ptype)
    device = _mesh_device(device, mesh)
    pipelined = pipelined and mesh is None
    R = ldpc_params.rate_float
    snr = 10.0 * np.log10(2.0 ** R - 1.0) + c_awgn_offset
    if start_snr is not None:
        snr = float(start_snr)
    records = []
    ctr = int(start_ctr)
    on_point_takes_ctr = (on_point is not None and
                          len(inspect.signature(on_point).parameters) >= 2)

    # Pipelined: the NEXT batch (same SNR, next counter window) is
    # dispatched before the current batch's counters are read back. When a
    # point stops, the one speculative batch is discarded and the counter
    # rewound to its start, so the next point consumes exactly the windows
    # the serial loop would have: the records are identical.
    def dispatch(snr_now, ctr0):
        if not pipelined:
            return None                      # computed in read()
        counts = _batch_counts(code, snr_now, _batch_generator(seed, ctr0, device),
                               batch, max_iters, dectype, bp_kernel)
        if counts.device.type != "cuda":
            return counts, None
        host = torch.empty(3, dtype=torch.int64, pin_memory=True)
        host.copy_(counts, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(counts.device))
        return host, done

    def read(fut, snr_now, ctr0):
        if not pipelined:
            return _ldpc_block_counts(code, snr_now, seed, ctr0, batch,
                                      max_iters, dectype, device, bp_kernel, mesh)
        host, done = fut
        if done is not None:
            done.synchronize()
        be, bl, it = host.tolist()
        return be, bl, it

    for point in range(int(start_point), n_measurements):
        nbit = nblk = nblocks = nit = 0
        inflight = None  # (ctr0, future)
        while nblk < min_errors and nblocks < max_blocks:
            if inflight is None:
                inflight = (ctr, dispatch(snr, ctr))
                ctr += batch
            spec = (ctr, dispatch(snr, ctr))  # speculative, same SNR
            ctr += batch
            be, bl, it = read(inflight[1], snr, inflight[0])
            inflight = spec
            nbit += be
            nblk += bl
            nit += it
            nblocks += batch
        # the speculative batch belongs to this point's SNR; the next point
        # measures elsewhere — discard it and rewind the counter (inflight is
        # None only if the stop condition held at once, e.g. min_errors=0)
        if inflight is not None:
            ctr = inflight[0]
        rec = (ldpc_params.standard, ldpc_params.rate, ldpc_params.z,
               ldpc_params.ptype, float(snr), nblocks, nblk,
               nblocks * code.K, nbit, nit)
        records.append(rec)
        snr += float(np.sqrt(p_step / nblocks))
        if on_point is not None:
            if on_point_takes_ctr:
                on_point(rec, {"point": point, "next_snr": float(snr),
                               "ctr": ctr})
            else:
                on_point(rec)
    return records
