"""LDPC belief propagation over the z-structured Tanner graph, in PyTorch.

Counterpart of `ldpc_sparc_tpu/ops/bp.py`. Every nonzero protograph entry
(i, j, shift s) is a z x z cyclically shifted identity that joins check
(i, c) to variable (j, (c + s) mod z). Messages live in a dense (E, z) array
per codeword, one row per protograph edge, in check order; the variable
order is the fixed permutation `to_var` along z. One iteration:

  variable update:  tot[j] = ch[j] + sum_{e: col(e)=j} c2v_var[e]
                    v2c_var[e] = tot[col(e)] - c2v_var[e]
  check update:     the forward-backward Lxor trellis along each check row's
                    padded edge list (`lxfb`)

The batch of codewords is the leading dimension: (B, E, z). The decode stops
a codeword once all its parity checks hold and freezes it (its messages and
its APP keep the values of that iteration) exactly as the JAX decoder does,
so a codeword's result does not depend on what else is in the batch.

The variable sum is taken in the order of the hand-written kernel
(`ops/bp_cuda.py`): ch first, then the column's edges in ascending id. The
JAX decoder sums the edges first (`segment_sum`) and adds ch last, so the two
packages agree to float32 rounding, not bit for bit.

`bp_decode` runs the kernel on a CUDA tensor (or raises) when `bp_kernel`
is True, and the plain decode `_decode_lanes` otherwise and on the CPU.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

_BIG = 1e30  # padding LLR: Lxor identity element (certainly-even parity)


# --------------------------------------------------------------------------
# Graph layout (host-side, numpy, build time)
# --------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)  # eq=False: hash by identity (a cache key)
class TannerGraph:
    """Static z-structured Tanner-graph layout for one protograph code."""

    z: int
    Np: int                 # protograph columns (24)
    Mp: int                 # protograph rows
    E: int                  # number of edges (nonzero protograph entries)
    edge_row: np.ndarray    # (E,) protograph row of each edge
    edge_col: np.ndarray    # (E,) protograph column of each edge
    edge_shift: np.ndarray  # (E,) cyclic shift of each edge
    to_var: np.ndarray      # (E, z) permutation: chk-aligned -> var-aligned
    to_chk: np.ndarray      # (E, z) inverse permutation
    dc_max: int             # max check degree
    chk_edges: np.ndarray   # (Mp, dc_max) edge ids per check row, -1 padded

    @classmethod
    def build(cls, proto: np.ndarray, z: int) -> "TannerGraph":
        Mp, Np = proto.shape
        rr, cc = np.nonzero(proto != -1)
        shifts = proto[rr, cc] % z
        E = rr.size
        vpos = np.arange(z)[None, :]
        # check (i, c) <-> variable (j, (c + s) mod z):
        #   m_var[e, v] = m_chk[e, (v - s) mod z]
        to_var = (vpos - shifts[:, None]) % z
        to_chk = (vpos + shifts[:, None]) % z
        deg = np.bincount(rr, minlength=Mp)
        dc_max = int(deg.max())
        chk_edges = -np.ones((Mp, dc_max), dtype=np.int64)
        for i in range(Mp):
            ids = np.flatnonzero(rr == i)
            chk_edges[i, :ids.size] = ids
        return cls(z=z, Np=Np, Mp=Mp, E=E,
                   edge_row=rr.astype(np.int32), edge_col=cc.astype(np.int32),
                   edge_shift=shifts.astype(np.int32),
                   to_var=to_var.astype(np.int32), to_chk=to_chk.astype(np.int32),
                   dc_max=dc_max, chk_edges=chk_edges)

    @property
    def Nv(self) -> int:
        return self.Np * self.z

    @property
    def Nc(self) -> int:
        return self.Mp * self.z


def column_edges(g: TannerGraph) -> np.ndarray:
    """(Np, dv_max) edge ids of each protograph column in ascending order,
    -1 padded: the order in which both decoders add a column's messages."""
    deg = np.bincount(g.edge_col, minlength=g.Np)
    out = -np.ones((g.Np, int(deg.max())), dtype=np.int64)
    for j in range(g.Np):
        ids = np.flatnonzero(g.edge_col == j)
        out[j, :ids.size] = ids
    return out


class _GraphTensors(NamedTuple):
    to_var: torch.Tensor     # (E, z) int64
    to_chk: torch.Tensor     # (E, z) int64
    edge_col: torch.Tensor   # (E,)
    col: torch.Tensor        # (Np, dv_max), pad = E (a zero row)
    chk: torch.Tensor        # (Mp, dc_max), pad = E (a +_BIG row)
    pos: torch.Tensor        # (E,) each edge's slot in the flat (Mp*dc_max) rows


@functools.lru_cache(maxsize=64)
def _graph_tensors(g: TannerGraph, device: torch.device) -> _GraphTensors:
    col = column_edges(g)
    chk = g.chk_edges
    flat = chk.reshape(-1)
    pos = np.empty(g.E, dtype=np.int64)
    pos[flat[flat >= 0]] = np.flatnonzero(flat >= 0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)
    return _GraphTensors(to_var=t(g.to_var), to_chk=t(g.to_chk),
                         edge_col=t(g.edge_col), col=t(np.where(col < 0, g.E, col)),
                         chk=t(np.where(chk < 0, g.E, chk)), pos=t(pos))


# --------------------------------------------------------------------------
# Pairwise LLR-XOR (the reference's Lxor, c_ldpc.c:234-251)
# --------------------------------------------------------------------------

def lxor(L1: torch.Tensor, L2: torch.Tensor, correction: bool) -> torch.Tensor:
    """LLR of the XOR of two binary RVs given their LLRs.

    Min-sum core (product of signs, with sign(0) = +1, times the min of the
    magnitudes) plus the two-term correction that makes it exactly the
    sum-product rule. Elementwise.
    """
    sgn = torch.sign(L1) * torch.sign(L2)
    sgn = torch.where(sgn == 0.0, 1.0, sgn)
    out = sgn * torch.minimum(L1.abs(), L2.abs())
    if correction:
        out = out + torch.log1p(torch.exp(-(L1 + L2).abs()))
        out = out - torch.log1p(torch.exp(-(L1 - L2).abs()))
    return out


def lxfb(L: torch.Tensor, correction: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extrinsic LLRs along axis 0 via the forward-backward trellis
    (`Lxfb`, c_ldpc.c:294-314), vectorized over trailing axes.

    L: (D, ...) incoming LLRs (pad positions must hold +_BIG).
    Returns (extrinsic (D, ...), aggregate (...) = Lxor of all inputs, used
    for the parity stopping rule).
    """
    D = L.shape[0]
    f = [L[0]]
    b = [L[D - 1]]
    for k in range(1, D):
        f.append(lxor(f[-1], L[k], correction))
        b.append(lxor(b[-1], L[D - 1 - k], correction))
    b = b[::-1]
    outs = [b[1]] if D > 1 else [torch.full_like(L[0], _BIG)]
    for k in range(1, D - 1):
        outs.append(lxor(f[k - 1], b[k + 1], correction))
    if D > 1:
        outs.append(f[D - 2])
    return torch.stack(outs), b[0]


# --------------------------------------------------------------------------
# BP decode
# --------------------------------------------------------------------------

class BpResult(NamedTuple):
    app: torch.Tensor         # (..., Nv) a-posteriori LLRs
    iterations: torch.Tensor  # (...,)   iterations until parity satisfied


def _make_bp_iter(ch_blocks: torch.Tensor, g: TannerGraph, correction: bool,
                  corr_factor: float):
    """The single-BP-iteration step over (B, Np, z) batch-first state, shared
    by the stopping decoder (`_decode_lanes`) and the fixed-length traced
    one (`_decode_lanes_trace`)."""
    t = _graph_tensors(g, ch_blocks.device)
    B, z = ch_blocks.shape[0], g.z
    to_var = t.to_var.expand(B, -1, -1)
    to_chk = t.to_chk.expand(B, -1, -1)
    zero_row = ch_blocks.new_zeros(B, 1, z)
    big_row = ch_blocks.new_full((B, 1, z), _BIG)

    def one_iter(c2v, app, it, done):
        # ---- variable node rule ("sum", c_ldpc.c:54-68) ----
        c2v_var = torch.gather(c2v, 2, to_var)               # (B, E, z)
        padded = torch.cat([c2v_var, zero_row], 1)
        tot = ch_blocks
        for k in range(t.col.shape[1]):                      # ascending edge id
            tot = tot + padded[:, t.col[:, k]]               # (B, Np, z)
        v2c_var = tot[:, t.edge_col] - c2v_var
        v2c = torch.gather(v2c_var, 2, to_chk)

        # ---- check node rule (Lxfb trellis, c_ldpc.c:183-197) ----
        rows = torch.cat([v2c, big_row], 1)[:, t.chk]        # (B, Mp, dc_max, z)
        ext, aggr = lxfb(rows.movedim(2, 0), correction)
        if not correction:
            ext = ext * corr_factor                          # min-sum heuristic
        # each edge sits in exactly one row slot: gather it back to edge order
        c2v_new = ext.movedim(0, 2).reshape(B, -1, z)[:, t.pos]

        parity_ok = (aggr > 0.0).reshape(B, -1).all(1)       # (B,)
        # freeze finished codewords; count = first t with parity satisfied
        frozen = done[:, None, None]
        return (torch.where(frozen, c2v, c2v_new), torch.where(frozen, app, tot),
                torch.where(done | parity_ok, it, it + 1), done | parity_ok)

    return one_iter


def _bp_init(ch_blocks: torch.Tensor, g: TannerGraph):
    B = ch_blocks.shape[0]
    return (ch_blocks.new_zeros(B, g.E, g.z), torch.zeros_like(ch_blocks),
            torch.zeros(B, dtype=torch.int32, device=ch_blocks.device),
            torch.zeros(B, dtype=torch.bool, device=ch_blocks.device))


def _decode_lanes(ch: torch.Tensor, g: TannerGraph, max_iters: int,
                  correction: bool, corr_factor: float) -> BpResult:
    """The plain batched decode. ch: (B, Nv). Runs until every codeword has
    satisfied parity or max_iters iterations (the C kernel's break,
    c_ldpc.c:104-106)."""
    B = ch.shape[0]
    ch_blocks = ch.reshape(B, g.Np, g.z)
    one_iter = _make_bp_iter(ch_blocks, g, correction, corr_factor)
    c2v, app, it, done = _bp_init(ch_blocks, g)
    for _ in range(max_iters):
        if bool(done.all()):
            break
        c2v, app, it, done = one_iter(c2v, app, it, done)
    return BpResult(app=app.reshape(B, g.Nv), iterations=it)


def _decode_lanes_trace(ch: torch.Tensor, g: TannerGraph, num_iters: int,
                        correction: bool, corr_factor: float):
    """Fixed-length BP recording the APP after EVERY iteration.

    Returns (app_traj (num_iters, B, Nv), iterations (B,)), with the same
    per-iteration math and freeze as `_decode_lanes` (a frozen codeword
    repeats its converged APP in the trace)."""
    B = ch.shape[0]
    ch_blocks = ch.reshape(B, g.Np, g.z)
    one_iter = _make_bp_iter(ch_blocks, g, correction, corr_factor)
    state = _bp_init(ch_blocks, g)
    traj = []
    for _ in range(num_iters):
        state = one_iter(*state)
        traj.append(state[1].reshape(B, g.Nv))
    app_traj = (torch.stack(traj) if traj
                else ch.new_zeros((0, B, g.Nv)))
    return app_traj, state[2]


def bp_decode_trace(ch: torch.Tensor, graph: TannerGraph, num_iters: int,
                    method: str = "sumprod", corr_factor: float = 0.7):
    """Decode channel LLRs, recording the APP after every BP iteration.

    ch: (..., Nv). Returns (app_traj (num_iters, ..., Nv), iterations (...))
    — app_traj[j] is the a-posteriori state after iteration j+1, with
    parity-converged codewords frozen (the semantics of `bp_decode`;
    app_traj[-1] equals bp_decode(...).app whenever num_iters >= the
    convergence iteration). Always the plain decode."""
    assert method in ("sumprod", "sumprod2", "minsum")
    batch_shape = ch.shape[:-1]
    flat = ch.reshape(-1, ch.shape[-1])
    traj, it = _decode_lanes_trace(flat, graph, num_iters, method != "minsum",
                                   corr_factor)
    return (traj.reshape((num_iters,) + batch_shape + (ch.shape[-1],)),
            it.reshape(batch_shape))


def bp_decode(ch: torch.Tensor, graph: TannerGraph, max_iters: int = 200,
              method: str = "sumprod", corr_factor: float = 0.7,
              bp_kernel: bool = True) -> BpResult:
    """Decode channel LLRs.

    ch        : (..., Nv) channel log-likelihood ratios (LLR > 0 => bit 0)
    method    : 'sumprod' / 'sumprod2' (exact, the reference's sumprod and
                sumprod2) or 'minsum' (scaled by corr_factor, c_ldpc.c:339-381)
    bp_kernel : True runs the hand-written kernel (`ops/bp_cuda.py`) on a
                CUDA tensor, or raises; on a CPU tensor, and with False on any
                device, the plain decode runs.
    Returns a-posteriori LLRs and per-codeword iteration counts.
    """
    assert method in ("sumprod", "sumprod2", "minsum")
    correction = method != "minsum"
    batch_shape = ch.shape[:-1]
    flat = ch.reshape(-1, ch.shape[-1]).contiguous()
    if bp_kernel:
        from .bp_cuda import bp_decode_kernel
        res = bp_decode_kernel(flat, graph, max_iters, correction, corr_factor)
    else:
        res = _decode_lanes(flat, graph, max_iters, correction, corr_factor)
    return BpResult(app=res.app.reshape(batch_shape + (ch.shape[-1],)),
                    iterations=res.iterations.reshape(batch_shape))
