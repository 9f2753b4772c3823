"""Plain reference for a SPARC Monte Carlo point: design build, draws,
encode, AMP decode, MAP decision and counters, in numpy and plain PyTorch.

It follows the reference simulator's AMP (LDPC_SPARC `sparc_public`), for
real unmodulated codes (K = 1) with the SRHT design ensemble, every base
matrix family (plain, power-allocated, spatially coupled), and the seed
conventions a Monte Carlo point uses:

* point seed `ps`; trial t draws its bits, then its noise, from one
  `torch.Generator` seeded from `SeedSequence(flatten((ps, t)))`;
* trial t decodes through design t % n_designs, built from
  `np.random.default_rng((ps, d))`: per nonzero block, row-major, the
  sorted index set (`choice` without replacement), then the +-1 signs;
* the trials of one design decode as one batch, each row frozen once its
  psi stops moving (the stop rule: every column block's psi within
  atol 2 * float32 resolution + rtol * |psi| of the last iteration's).

Everything is float32, as the configuration states. The transform is a
plain Walsh-Hadamard transform (radix-32 stages as float32 matmuls, TF32
off); blocks that share a row or column block are summed in block order,
so a run repeats bit for bit. Nothing here imports the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


# --------------------------------------------------------------------------
# seeds
# --------------------------------------------------------------------------

def _flatten(seed) -> list[int]:
    if isinstance(seed, (tuple, list)):
        return [v for s in seed for v in _flatten(s)]
    return [int(seed)]


def trial_generator(point_seed, trial: int, device) -> torch.Generator:
    """The generator of trial `trial` of the point seeded `point_seed`."""
    state = np.random.SeedSequence(_flatten((point_seed, trial))).generate_state(
        1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]))
    return gen


# --------------------------------------------------------------------------
# base matrix
# --------------------------------------------------------------------------

def base_matrix(cfg: dict, awgn_var: float) -> np.ndarray:
    """The (Lr, Lc) float64 base matrix: [[P]] for a plain code, the
    iterative power allocation for a power-allocated one, spread over omega
    row blocks of Lambda + omega - 1 for a spatially coupled one."""
    P = float(cfg["P"])
    if cfg.get("power_allocated"):
        B, R_pa = int(cfg["B"]), float(cfg["R"]) * float(cfg["R_PA_ratio"])
        Q = np.zeros(B)
        for b in range(B):
            p_block = 2.0 * np.log(2.0) * R_pa * (awgn_var + P - Q.mean())
            p_spread = (B * P - Q.sum()) / (B - b)
            if p_block > p_spread:
                Q[b] = p_block
            else:
                Q[b:] = p_spread
                break
        Q /= Q.mean() / P
    else:
        Q = np.array(P)
    if not cfg.get("spatially_coupled"):
        return np.atleast_1d(Q)[None, :].astype(np.float64)
    omega, lam = int(cfg["omega"]), int(cfg["Lambda"])
    Lr = lam + omega - 1
    q = np.atleast_1d(Q)
    W = np.zeros((Lr, lam * q.size))
    for c in range(lam):
        W[c:c + omega, c * q.size:(c + 1) * q.size] = q * Lr / omega
    return W


def code_shape(cfg: dict, awgn_var: float = 1.0):
    """(W, n, bit_len): the base matrix, the codeword length (rounded to a
    multiple of the row blocks) and the message bits L log2 M."""
    W = base_matrix(cfg, awgn_var)
    L, M = int(cfg["L"]), int(cfg["M"])
    bit_len = L * (M.bit_length() - 1)
    n = int(round(bit_len / float(cfg["R"])))
    Lr = W.shape[0]
    if Lr > 1:
        n = int(round(n / Lr)) * Lr
    return W, n, bit_len


# --------------------------------------------------------------------------
# transform and design
# --------------------------------------------------------------------------

def fwht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalised Sylvester Walsh-Hadamard transform of the last axis."""
    w = x.shape[-1]
    if w & (w - 1):
        raise ValueError(f"width {w} is not a power of two")
    y = x.reshape(-1, w)
    done, log_w = 0, w.bit_length() - 1
    while done < log_w:
        k = min(5, log_w - done)
        f, s = 1 << k, 1 << done
        h = torch.ones(1, 1, dtype=x.dtype, device=x.device)
        while h.shape[0] < f:
            h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
        # bits [done, done + k) of the index are the middle axis
        y = y.reshape(-1, f) @ h if s == 1 else torch.matmul(h, y.reshape(-1, f, s))
        done += k
    return y.reshape(x.shape)


def _rank(target: np.ndarray) -> np.ndarray:
    """Each block's place among the blocks before it with the same target."""
    rank = np.zeros(len(target), dtype=np.int64)
    seen: dict[int, int] = {}
    for e, r in enumerate(target.tolist()):
        rank[e] = seen.get(r, 0)
        seen[r] = rank[e] + 1
    return rank


def _as_slice(at: np.ndarray):
    """`at` as a slice where it runs on by ones, else as it is."""
    run_on = len(at) and np.array_equal(at, np.arange(at[0], at[0] + len(at)))
    return slice(int(at[0]), int(at[0]) + len(at)) if run_on else at


def _passes(rank: np.ndarray, place: np.ndarray, target: np.ndarray) -> list:
    """Pass k: (places, targets) of the blocks of rank k, whose targets are
    all different, each a slice where it runs on."""
    out = []
    for k in range(int(rank.max(initial=-1)) + 1):
        order = np.argsort(place[rank == k])
        out.append((_as_slice(place[rank == k][order]),
                    _as_slice(target[rank == k][order])))
    return out


def _segment_sum(parts: torch.Tensor, passes: tuple, n_out: int) -> torch.Tensor:
    """(B, E, m) block outputs summed by target into (B, n_out, m), each
    target's blocks in block order: one add a pass, so no two blocks land
    on one target at once (float atomics would add them in a racing order,
    and a decision on a near-tie would follow the race)."""
    out = parts.new_zeros(parts.shape[0], n_out, parts.shape[2])
    for sel, target in passes:
        if isinstance(target, slice):
            out[:, target] += parts[:, sel]
        else:
            out.index_add_(1, target, parts[:, sel])
    return out


@dataclass
class Design:
    """Blockwise SRHT operator: block e (rows[e], cols[e]) is
    scale[e] * (index side) H_w (signed window [offset, offset + dim))."""

    rows: torch.Tensor
    cols: torch.Tensor
    idx: torch.Tensor
    signs: torch.Tensor
    scale: torch.Tensor
    Lr: int
    Lc: int
    Mr: int
    Mc: int
    w: int
    offset: int
    ab_passes: tuple
    az_passes: tuple

    @classmethod
    def build(cls, W: np.ndarray, L: int, M: int, n: int, seed, device) -> "Design":
        Lr, Lc = W.shape
        Mr, Mc = n // Lr, L * M // Lc
        small, large = min(Mr, Mc), max(Mr, Mc)
        if large & (large - 1) == 0:
            w, offset, base = large, 0, np.arange(large, dtype=np.int32)
        else:
            w, offset = 1 << large.bit_length(), 1
            Q = 1 << int(np.floor(np.log2(large)))
            while Q <= small:
                Q *= 2
            base = np.arange(1, min(Q, w), dtype=np.int32)
        rng = np.random.default_rng(seed)
        rows, cols, idx, signs = [], [], [], []
        for r in range(Lr):
            for c in range(Lc):
                if W[r, c] != 0:
                    rows.append(r)
                    cols.append(c)
                    idx.append(np.sort(rng.choice(base, small, replace=False)))
                    signs.append(rng.integers(0, 2, large).astype(np.float32) * 2 - 1)
        # blocks stored in the order of the wide side's passes, so that
        # each of those passes reads a slice of the block outputs
        rows, cols = np.asarray(rows), np.asarray(cols)
        row_rank, col_rank = _rank(rows), _rank(cols)
        order = np.argsort(col_rank if Mc >= Mr else row_rank, kind="stable")
        place = np.argsort(order)
        t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        tensor = lambda a: a if isinstance(a, slice) else t(a, torch.int64)
        passes = lambda rank, target: tuple(
            (tensor(sel), tensor(tg)) for sel, tg in _passes(rank, place, target))
        rows_p, cols_p = rows[order], cols[order]
        scale = np.sqrt(W[rows_p, cols_p] / L).astype(np.float32)
        return cls(t(rows_p, torch.int64), t(cols_p, torch.int64),
                   t(np.stack(idx)[order], torch.int64),
                   t(np.stack(signs)[order], torch.float32),
                   t(scale, torch.float32), Lr, Lc, Mr, Mc, w, offset,
                   passes(row_rank, rows), passes(col_rank, cols))

    def _blocks(self, v: torch.Tensor, index_in: bool, out_dim: int) -> torch.Tensor:
        """(B, E, in) block inputs -> (B, E, out) block outputs."""
        B, E, in_dim = v.shape
        X = v.new_zeros(B, E, self.w)
        if index_in:
            X.scatter_(2, self.idx.expand(B, E, -1), v * self.scale[:, None])
            return fwht(X)[..., self.offset:self.offset + out_dim] * self.signs
        X[..., self.offset:self.offset + in_dim] = v * self.signs
        return fwht(X).gather(2, self.idx.expand(B, E, -1)) * self.scale[:, None]

    def ab(self, beta: torch.Tensor) -> torch.Tensor:
        """A beta: (B, L M) -> (B, n)."""
        B = beta.shape[0]
        parts = self._blocks(beta.reshape(B, self.Lc, self.Mc)[:, self.cols],
                             self.Mr > self.Mc, self.Mr)
        return _segment_sum(parts, self.ab_passes, self.Lr).reshape(B, -1)

    def az(self, z: torch.Tensor) -> torch.Tensor:
        """A^T z: (B, n) -> (B, L M)."""
        B = z.shape[0]
        parts = self._blocks(z.reshape(B, self.Lr, self.Mr)[:, self.rows],
                             self.Mr <= self.Mc, self.Mc)
        return _segment_sum(parts, self.az_passes, self.Lc).reshape(B, -1)


# --------------------------------------------------------------------------
# AMP
# --------------------------------------------------------------------------

def amp(y: torch.Tensor, A: Design, W: np.ndarray, L: int, M: int,
        awgn_var: float, t_max: int, rtol: float):
    """AMP on y (B, n) for t_max - 1 iterations with the per-row freeze;
    returns the MAP section indices (B, L) and the iterations run (B,)."""
    dev = y.device
    Wt = torch.as_tensor(W, dtype=torch.float32, device=dev)
    Lr, Lc = W.shape
    B, n = y.shape
    Mr, Mc, per_col = n // Lr, L * M // Lc, L // Lc
    atol = 2 * float(np.finfo(np.float32).resolution)
    beta = torch.zeros(B, L * M, device=dev)
    z, s = torch.zeros_like(y), torch.zeros_like(beta)
    phi = torch.ones(B, Lr, device=dev)
    psi = torch.ones(B, Lc, device=dev)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    t_final = torch.zeros(B, dtype=torch.int64, device=dev)
    for t in range(t_max - 1):
        gamma = psi @ Wt.T / Lc
        if t == 0:
            z_new = y
        else:
            onsager = (gamma / phi)[:, :, None] * z.reshape(B, Lr, Mr)
            z_new = y - A.ab(beta) + onsager.reshape(B, n)
        phi_new = awgn_var + gamma
        tau = (L / Mr) / ((1.0 / phi_new) @ Wt)
        r = A.az((z_new.reshape(B, Lr, Mr) / phi_new[:, :, None]).reshape(B, n))
        s_new = beta.reshape(B, Lc, Mc) + tau[:, :, None] * r.reshape(B, Lc, Mc)
        sec = (s_new / tau[:, :, None]).reshape(B, L, M)
        beta_new = torch.softmax(sec, dim=-1).reshape(B, L * M)
        psi_new = 1.0 - (beta_new.reshape(B, Lc, Mc) ** 2).sum(-1) / per_col
        converged = (t > 0) & ((psi_new - psi).abs() <= atol + rtol * psi.abs()).all(-1)
        keep = stopped[:, None]
        beta = torch.where(keep, beta, beta_new)
        z = torch.where(keep, z, z_new)
        s = torch.where(keep, s, s_new.reshape(B, L * M))
        phi = torch.where(keep, phi, phi_new)
        psi = torch.where(keep, psi, psi_new)
        t_final = torch.where(stopped, t_final, t + 1)
        stopped = stopped | converged
        if bool(stopped.all()):     # every row frozen: nothing changes further
            break
    return s.reshape(B, L, M).argmax(-1), t_final


# --------------------------------------------------------------------------
# one Monte Carlo point
# --------------------------------------------------------------------------

def point_counts(cfg: dict, awgn_var: float, point_seed, n_trials: int,
                 n_designs: int, device) -> dict:
    """The counters of one point (bit_errs, bits, sec_errs, sections,
    frame_errs, frames, iters), and per-trial `trial_iters`,
    `trial_bit_errs` (numpy, trial order) for a closer look."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _point_counts(cfg, awgn_var, point_seed, n_trials, n_designs, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@torch.no_grad()
def _point_counts(cfg, awgn_var, point_seed, n_trials, n_designs, device):
    L, M = int(cfg["L"]), int(cfg["M"])
    logM = M.bit_length() - 1
    W, n, bit_len = code_shape(cfg, awgn_var)
    t_iters = np.zeros(n_trials, dtype=np.int64)
    t_bits = np.zeros(n_trials, dtype=np.int64)
    t_secs = np.zeros(n_trials, dtype=np.int64)
    weights = 1 << torch.arange(logM - 1, -1, -1, device=device)
    for d in range(n_designs):
        trials = list(range(d, n_trials, n_designs))
        if not trials:
            continue
        A = Design.build(W, L, M, n, (point_seed, d), device)
        gens = [trial_generator(point_seed, t, device) for t in trials]
        bits = torch.stack([torch.randint(0, 2, (bit_len,), generator=g, device=device)
                            for g in gens]).to(torch.int64)
        sent = (bits.reshape(-1, L, logM) * weights).sum(-1)          # (B, L)
        beta0 = torch.zeros(len(trials), L, M, device=device)
        beta0.scatter_(2, sent[..., None], 1.0)
        x = A.ab(beta0.reshape(len(trials), L * M))
        y = torch.stack([xi + torch.randn(xi.shape, generator=g, device=device)
                         * float(np.sqrt(awgn_var)) for xi, g in zip(x, gens)])
        del x, beta0
        got, t_final = amp(y, A, W, L, M, awgn_var, int(cfg["t_max"]),
                           float(cfg.get("rtol", 1e-6)))
        got_bits = (got[..., None] >> torch.arange(logM - 1, -1, -1, device=device)) & 1
        t_bits[trials] = (got_bits.reshape(len(trials), -1) != bits).sum(-1).cpu().numpy()
        t_secs[trials] = (got != sent).sum(-1).cpu().numpy()
        t_iters[trials] = t_final.cpu().numpy()
    return {"bit_errs": int(t_bits.sum()), "bits": n_trials * bit_len,
            "sec_errs": int(t_secs.sum()), "sections": n_trials * L,
            "frame_errs": int((t_bits > 0).sum()), "frames": n_trials,
            "iters": int(t_iters.sum()),
            "trial_iters": t_iters, "trial_bit_errs": t_bits}
