"""Plain reference for a point of the LDPC waterfall campaign: the draws,
the encode, the BPSK channel, the sum-product decode and the point's
counts, in numpy and plain PyTorch.

It follows the reference simulator's `sim()` (LDPC_SPARC,
`ldpc_jossy/py/ldpc_awgn.py:60-123`) at one SNR point:

* the code: IEEE 802.11n rate 1/2 at z = 81 (Std 802.11n-2009, Annex R;
  `ldpc_jossy/py/ldpc.py:57-271`), its own base matrix below, as
  `reference/concat.py`'s `Code` (edges in row-major order, shift s joins
  check (i, c) to variable (j, (c + s) mod z)); N = 1944, K = 972;
* a batch of `batch` codewords whose first codeword is number `ctr` of the
  campaign's running counter draws its information bits, then its noise,
  from the generator of `SeedSequence((seed, ctr))` (`reference/sparc.py`'s
  `trial_generator`), with the same torch calls in the same order as the
  program's batch;
* the encode is `Code.encode`, the dual-diagonal parity chain
  (`ldpc_jossy/py/ldpc.py:400-460`), in numpy;
* the channel: BPSK 1 - 2x plus sqrt(sigma^2) times the noise, sigma^2 =
  10^(-SNR/10) (1/sigma^2 of BPSK symbols, `ldpc_awgn.py:51-53`), and LLRs
  (2 / sigma^2) y, in the same float32 operations;
* the decode: `reference/concat.py`'s sum-product BP (`bp_decode` there):
  each variable sums its channel LLR first, then its edges in ascending
  edge id; each check takes the forward-backward Lxor trellis of its
  edges; a codeword stops at the first iteration whose checks all hold,
  keeps that iteration's APP, and counts the iterations after which they
  did not yet hold (at most `max_iters`);
* per codeword, bit errors over all N code bits (the APP's sign against
  the codeword), a block error where there is one; summed over the point.

Departures, none of which moves a number compared: the decode drops the
codewords that stopped from its working set between iterations (every
codeword's arithmetic is its own, so it is concat.py's `bp_decode` with
less work; the tests hold the two equal bit for bit), and a point decodes
in chunks of whole batches. `message_dtype=torch.bfloat16` rounds every
message to bfloat16 after each update (the variable-to-check messages
after the variable rule, the check-to-variable messages after the check
rule), the sums and the trellis staying float32: the nearest precision
below the float32 the configuration states, the calibration's control (c),
never the check's reference. Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .concat import BIG, Code, _lxor
from .sparc import trial_generator

# IEEE 802.11n rate 1/2 base matrix at z = 81 ("." = no edge)
IEEE80211N_R12_Z81 = """\
57 . . . 50 . 11 . 50 . 79 . 1 0 . . . . . . . . . .
3 . 28 . 0 . . . 55 7 . . . 0 0 . . . . . . . . .
30 . . . 24 37 . . 56 14 . . . . 0 0 . . . . . . . .
62 53 . . 53 . . 3 35 . . . . . . 0 0 . . . . . . .
40 . . 20 66 . . 22 28 . . . . . . . 0 0 . . . . . .
0 . . . 8 . 42 . 50 . . 8 . . . . . 0 0 . . . . .
69 79 79 . . . 56 . 52 . . . 0 . . . . . 0 0 . . . .
65 . . . 38 57 . . 72 . 27 . . . . . . . . 0 0 . . .
64 . . . 14 52 . . 30 . . 32 . . . . . . . . 0 0 . .
. 45 . 70 0 . . . 77 9 . . . . . . . . . . . 0 0 .
2 56 . 57 35 . . . . . 12 . . . . . . . . . . . 0 0
24 . 61 . 60 . . 27 51 . . 16 1 . . . . . . . . . . 0
"""
Z = 81
CHUNK_ROWS = 51200      # codewords a decode call takes at most (half a point)


def protograph() -> np.ndarray:
    """The (12, 24) base matrix, -1 where there is no edge."""
    return np.array([[-1 if t == "." else int(t) for t in line.split()]
                     for line in IEEE80211N_R12_Z81.strip().splitlines()],
                    dtype=np.int64)


def build_code(cfg: dict | None = None) -> Code:
    """The configuration's code (802.11n rate 1/2, z = 81, type A: the one
    this reference holds)."""
    if cfg is not None and (cfg["standard"], cfg["rate"], int(cfg["z"]),
                            cfg.get("ptype", "A")) != ("802.11n", "1/2", Z, "A"):
        raise ValueError("the reference holds the 802.11n rate-1/2 z=81 code only")
    proto = protograph()
    row, col = np.nonzero(proto != -1)
    return Code(Z, proto, row, col, proto[row, col] % Z)


def check_degrees(code: Code) -> list[int]:
    """Each protograph row's check degree (z checks each)."""
    return np.bincount(code.row, minlength=code.Mp).tolist()


def bp_decode(ch: torch.Tensor, code: Code, max_iters: int,
              message_dtype: torch.dtype = torch.float32):
    """Sum-product BP of channel LLRs ch (B, N): (app (B, N), iterations
    (B,) int64), concat.py's `bp_decode` on the codewords still running
    (see the module docstring; `message_dtype` the messages' rounding)."""
    B, z, dev = ch.shape[0], code.z, ch.device
    E = len(code.row)
    pos = torch.arange(z, device=dev)
    shift = torch.as_tensor(code.shift, device=dev)[:, None]
    var_of = ((pos[None, :] + shift) % z)[None]              # check slot -> variable
    chk_of = ((pos[None, :] - shift) % z)[None]              # variable slot -> check
    col_edges = [np.flatnonzero(code.col == j) for j in range(code.Np)]
    row_edges = [np.flatnonzero(code.row == i) for i in range(code.Mp)]
    dv, dc = max(map(len, col_edges)), max(map(len, row_edges))
    pad = lambda lists, d: torch.as_tensor(np.array(
        [np.concatenate([e, np.full(d - len(e), E)]) for e in lists]), device=dev)
    cols, rows = pad(col_edges, dv), pad(row_edges, dc)     # E: a padding edge
    slot = torch.empty(E, dtype=torch.int64, device=dev)    # each edge's place in rows
    flat = rows.reshape(-1)
    slot[flat[flat < E]] = torch.nonzero(flat < E)[:, 0]
    col_of = torch.as_tensor(code.col, device=dev)
    if message_dtype == torch.float32:
        rnd = lambda t: t
    else:
        rnd = lambda t: t.to(message_dtype).to(torch.float32)

    app = ch.new_zeros(B, code.Np, z)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)
    live = torch.arange(B, device=dev)                       # codewords still running
    chb = ch.reshape(B, code.Np, z)
    c2v = ch.new_zeros(B, E, z)                              # check order, live rows
    tot = torch.zeros_like(chb)
    for _ in range(max_iters):
        n = live.numel()
        if n == 0:
            break
        # variables: channel LLR first, then the edges in ascending id
        at_var = torch.cat([c2v.gather(2, chk_of.expand(n, E, z)),
                            c2v.new_zeros(n, 1, z)], 1)
        tot = chb
        for k in range(dv):
            tot = tot + at_var[:, cols[:, k]]
        v2c = rnd((tot[:, col_of] - at_var[:, :E]).gather(2, var_of.expand(n, E, z)))
        # checks: the forward-backward trellis along each row's edges (the
        # row's k-th inputs contiguous, (dc, n, Mp, z))
        L = torch.cat([v2c, c2v.new_full((n, 1, z), BIG)], 1)[:, rows.t()] \
            .transpose(0, 1).contiguous()
        fwd, bwd = [L[0]], [L[dc - 1]]
        for k in range(1, dc):
            fwd.append(_lxor(fwd[-1], L[k]))
            bwd.append(_lxor(bwd[-1], L[dc - 1 - k]))
        bwd = bwd[::-1]
        ext = [bwd[1]] + [_lxor(fwd[k - 1], bwd[k + 1]) for k in range(1, dc - 1)] \
            + [fwd[dc - 2]]
        new = rnd(torch.stack(ext, 2).reshape(n, -1, z)[:, slot])
        holds = (bwd[0] > 0).reshape(n, -1).all(1)
        stop, go = torch.nonzero(holds)[:, 0], torch.nonzero(~holds)[:, 0]
        app[live[stop]] = tot[stop]
        iters[live[go]] += 1
        live, chb, c2v, tot = live[go], chb[go], new[go], tot[go]
    app[live] = tot                               # at the cap: the last iteration's
    return app.reshape(B, code.N), iters


def batch_llrs(code: Code, snr_db: float, seed, ctrs: list[int], batch: int, device):
    """The codewords (B, N) int64 and channel LLRs (B, N) float32 of the
    batches whose first codewords are `ctrs`, each drawn as the program
    draws it, in order."""
    sigma2 = 1.0 / 10 ** (snr_db / 10.0)
    bits, noise = [], []
    for ctr in ctrs:
        gen = trial_generator(seed, ctr, device)
        bits.append(torch.randint(0, 2, (batch, code.K), generator=gen, device=device,
                                  dtype=torch.int32))
        noise.append(torch.randn(batch, code.N, generator=gen, device=device))
    info = torch.cat(bits).cpu().numpy().astype(np.int64)
    x = torch.as_tensor(code.encode(info), device=device)
    y = (1.0 - 2.0 * x.to(torch.float32)) + math.sqrt(sigma2) * torch.cat(noise)  # BPSK
    return x, (2.0 / sigma2) * y


def point_counts(cfg: dict, snr_db: float, seed, ctr: int, blocks: int, batch: int,
                 device, message_dtype: torch.dtype = torch.float32) -> dict:
    """The counts of codewords ctr .. ctr + blocks - 1, in batches of
    `batch`: `frames`, `errs` (block errors), `bit_errs`, `iters`."""
    if blocks % batch:
        raise ValueError(f"a point is whole batches: {blocks} blocks, batch {batch}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _point_counts(build_code(cfg), snr_db, seed, ctr, blocks, batch,
                             torch.device(device), int(cfg["max_iters"]),
                             message_dtype, max(batch, CHUNK_ROWS // batch * batch))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@torch.no_grad()
def _point_counts(code, snr_db, seed, ctr, blocks, batch, device, max_iters,
                  message_dtype, chunk):
    out = {"frames": blocks, "errs": 0, "bit_errs": 0, "iters": 0}
    for lo in range(0, blocks, chunk):
        x, llr = batch_llrs(code, snr_db, seed,
                            list(range(ctr + lo, ctr + min(lo + chunk, blocks), batch)),
                            batch, device)
        app, iters = bp_decode(llr, code, max_iters, message_dtype)
        biterrs = (x != (app < 0).to(x.dtype)).sum(1)
        out["errs"] += int((biterrs > 0).sum())
        out["bit_errs"] += int(biterrs.sum())
        out["iters"] += int(iters.sum())
    return out
