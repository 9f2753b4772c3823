"""Monte Carlo on one device: the SPARC BER sweep, the concatenated
LDPC-SPARC sweep point and the LDPC waterfall campaign.

Counterpart of the single-device parts of
`ldpc_sparc_tpu/parallel/montecarlo.py`:

* `sparc_mc_counts` / `sparc_ber_sweep`: SPARC encode -> AWGN -> AMP ->
  count trials (the performance_plots sweep), for every family, real or
  complex, K=1 or K-PSK, with either design engine. The JAX package's contract
  holds: trial t draws its bits, then its noise, from one generator seeded
  from `rng.derive(seed, t)`, and uses design (seed, t % n_designs) with
  n_designs = min(8, n_trials). The counters are then a function of
  (seed, trial index) alone, however the trials are grouped: the trials
  of one design decode together, as one `decode_batch` call.
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
the two packages' counters agree statistically, not bit for bit. The mesh
fan-out is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import inspect
import math

import numpy as np
import torch

from ..config import ConcatLengths, DecodeParams, LdpcParams, SparcParams
from ..device import resolve_device
from ..models.concat import ConcatCodec
from ..models.ldpc import LdpcCode, get_code
from ..models.sparc import awgn_channel, decode_batch
from ..ops.bp import bp_decode
from ..ops.transforms import DesignStack, stack_designs
from ..utils import bits as bitops
from ..utils import rng as rngmod
from ..utils.metrics import location_value_errors


# --------------------------------------------------------------------------
# SPARC Monte Carlo
# --------------------------------------------------------------------------

def sparc_mc_counts(params: SparcParams, decode: DecodeParams, awgn_var: float,
                    seed, n_trials: int, n_designs: int | None = None,
                    engine: str = "srht", fwht_mode: str = "ms",
                    device=None, fused_denoiser: bool | None = None) -> dict:
    """Run n_trials independent SPARC encode -> AWGN -> AMP -> count trials.

    Trial t: bits then noise from `root_generator(derive(seed, t))`, design
    (seed, t % n_designs) by `engine` ('srht' or 'dft'). The trials of one
    design decode together, as one `decode_batch` call. fused_denoiser: see
    `models.sparc.amp_decode`.

    Returns the counters bit_errs, bits, sec_errs, sections, frame_errs,
    frames, iters; a modulated code adds loc_errs and val_errs, and its
    section errors are `location_value_errors`'.
    """
    device = resolve_device(device)
    if n_designs is None:
        n_designs = min(8, n_trials)
    designs = stack_designs(params, awgn_var, seed, n_designs, engine, device)
    M, K, L = params.M, params.K, params.L
    totals = torch.zeros(6, dtype=torch.int64, device=device)
    for d, design in enumerate(designs):
        gens = [rngmod.root_generator(rngmod.derive(seed, t), device)
                for t in range(d, n_trials, n_designs)]
        if not gens:
            continue
        bits = torch.stack([bitops.random_bits(g, params.bit_len) for g in gens])
        beta0 = bitops.bits_to_msg_vector(bits, M, K)
        x = design.ab(beta0, fwht_mode=fwht_mode)
        y = torch.stack([awgn_channel(xi, awgn_var, g) for xi, g in zip(x, gens)])
        beta, t_final = decode_batch(y, design, params, decode, awgn_var,
                                     fused_denoiser=fused_denoiser,
                                     fwht_mode=fwht_mode)
        bit_errs = (bitops.msg_vector_to_bits(beta, M, K) != bits).sum(-1)
        if params.modulated:
            _, (loc_e, val_e, sec_e) = location_value_errors(beta0, beta, L)
            loc_errs, val_errs = loc_e.sum(), val_e.sum()
        else:
            sec_e = (beta != beta0).reshape(-1, L, M).any(-1)
            loc_errs = val_errs = torch.zeros((), dtype=torch.int64, device=device)
        totals += torch.stack([bit_errs.sum(), sec_e.sum(), (bit_errs > 0).sum(),
                               t_final.sum(), loc_errs, val_errs])
    be, se, fe, it, le, ve = totals.tolist()
    counts = {"bit_errs": be, "bits": n_trials * params.bit_len,
              "sec_errs": se, "sections": n_trials * L,
              "frame_errs": fe, "frames": n_trials, "iters": it}
    if params.modulated:
        counts.update(loc_errs=le, val_errs=ve)
    return counts


def sparc_ber_sweep(params: SparcParams, decode: DecodeParams, awgn_vars, seed,
                    n_trials: int, engine: str = "srht", fwht_mode: str = "ms",
                    device=None, fused_denoiser: bool | None = None) -> list[dict]:
    """BER / SER / FER at each noise level (the performance_plots sweep),
    and LER / VER for a modulated code; point i is seeded (seed, i)."""
    device = resolve_device(device)
    rows = []
    for i, v in enumerate(np.atleast_1d(awgn_vars)):
        c = sparc_mc_counts(params, decode, float(v), (seed, i), n_trials,
                            engine=engine, fwht_mode=fwht_mode, device=device,
                            fused_denoiser=fused_denoiser)
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
                      n_designs: int | None = None, device=None) -> DesignStack:
    """The Monte Carlo's designs, one per trial: trial t's is
    (seed, t % n_designs), n_designs = min(8, n_trials) by default. The
    n_designs designs are built once and their leaves gathered per trial."""
    device = resolve_device(device)
    if n_designs is None:
        n_designs = min(8, n_trials)
    didx = torch.arange(n_trials, device=device) % n_designs
    return codec.build_designs(seed, n_designs, device).for_trials(didx)


def concat_mc_transmit(codec: ConcatCodec, designs: DesignStack, awgn_var: float,
                       seed, fwht_kernel: bool = True):
    """(user_bits (B, user_bits_len) int32, ys (B, n)) of the B = designs.D
    trials: trial t draws its user bits, then its noise, from
    `root_generator(derive(seed, t))`; the bits are LDPC-encoded, spread by
    trial t's design and sent over AWGN."""
    gens = [rngmod.root_generator(rngmod.derive(seed, t), designs.device)
            for t in range(designs.D)]
    user_bits = torch.stack([bitops.random_bits(g, codec.user_bits_len)
                             for g in gens]).to(torch.int32)
    _, beta0 = codec.message_vector(user_bits)
    x = designs.ab(beta0 / codec.c_amp, fwht_kernel)
    ys = torch.stack([awgn_channel(xi, awgn_var, g) for xi, g in zip(x, gens)])
    return user_bits, ys


def concat_mc_trial_errors(sparc_params: SparcParams, ldpc_params: LdpcParams,
                           lengths: ConcatLengths, ldpc_protected: bool,
                           decode_params: DecodeParams, awgn_var: float, seed,
                           n_trials: int, decoder: str = "sequential",
                           n_designs: int | None = None, device=None,
                           fwht_kernel: bool = True,
                           bp_kernel: bool = True) -> np.ndarray:
    """Per-trial user-bit error counts of n_trials encode -> AWGN -> AMP + BP
    trials, decoded as one `ConcatCodec.decode_batch` call.

    Trial t: user bits then noise from `root_generator(derive(seed, t))`,
    design (seed, t % n_designs), n_designs = min(8, n_trials) by default;
    so entry t is a function of (seed, t) alone. Returns an (n_trials,)
    int64 numpy array (divide by `ConcatCodec.user_bits_len` for the
    per-run BERs, whose min and max are the reference's error bars).
    """
    device = resolve_device(device)
    codec = ConcatCodec(sparc_params, ldpc_params, lengths, ldpc_protected)
    designs = concat_mc_designs(codec, seed, n_trials, n_designs, device)
    user_bits, ys = concat_mc_transmit(codec, designs, awgn_var, seed, fwht_kernel)
    bits_out = codec.decode_batch(ys, designs, decode_params, decoder,
                                  fwht_kernel=fwht_kernel, bp_kernel=bp_kernel)
    return (user_bits != bits_out).sum(-1).cpu().numpy()


def concat_ber_point(sparc_params: SparcParams, ldpc_params: LdpcParams,
                     lengths: ConcatLengths, ldpc_protected: bool,
                     decode_params: DecodeParams, awgn_var: float, seed,
                     n_trials: int, decoder: str = "sequential", device=None,
                     fwht_kernel: bool = True, bp_kernel: bool = True) -> dict:
    """One sweep point: mean, min and max BER over n_trials (the aggregation
    of performance_plots_general.py:120-126)."""
    codec = ConcatCodec(sparc_params, ldpc_params, lengths, ldpc_protected)
    errs = concat_mc_trial_errors(
        sparc_params, ldpc_params, lengths, ldpc_protected, decode_params,
        awgn_var, seed, n_trials, decoder, device=device,
        fwht_kernel=fwht_kernel, bp_kernel=bp_kernel)
    bers = errs / codec.user_bits_len
    return {"ber": float(np.mean(bers)), "ber_min": float(np.min(bers)),
            "ber_max": float(np.max(bers)),
            "frame_errs": int(np.sum(errs > 0)), "frames": int(n_trials),
            "bit_errs": int(np.sum(errs)),
            "bits": int(n_trials * codec.user_bits_len)}


# --------------------------------------------------------------------------
# LDPC waterfall campaign
# --------------------------------------------------------------------------


def _batch_counts(code: LdpcCode, snr_db: float, gen: torch.Generator,
                  batch: int, max_iters: int, dectype: str,
                  bp_kernel: bool) -> torch.Tensor:
    """Encode, transmit and decode one batch of random codewords; returns
    (bit_errs, block_errs, iters) summed over the batch, as one (3,) int64
    tensor on the generator's device (one copy to read back)."""
    dev = gen.device
    sigma2 = 1.0 / 10 ** (snr_db / 10.0)
    u = torch.randint(0, 2, (batch, code.K), generator=gen, device=dev,
                      dtype=torch.int32)
    x = code.encode(u)
    noise = torch.randn(batch, code.N, generator=gen, device=dev)
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
                       bp_kernel: bool = True):
    """Decode one batch of random codewords at SNR (dB); returns
    (bit_errs, block_errs, iters) summed over trials ctr..ctr+batch, read
    back in one device-to-host copy."""
    out = _batch_counts(code, snr_db,
                        _batch_generator(seed, ctr, resolve_device(device)),
                        batch, max_iters, dectype, bp_kernel)
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
                            start_ctr: int = 0, device=None):
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
    device = resolve_device(device)
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
                                      max_iters, dectype, device, bp_kernel)
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
