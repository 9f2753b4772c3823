"""Section-sharded SPARC AMP: the tensor-parallel 'sec' axis.

Counterpart of `ldpc_sparc_tpu/parallel/sharded.py`. The spatially coupled
base matrix factors the design into (Lr x Lc) independent Hadamard blocks
(sparc_public/sparc.py:831-875); the column blocks are what the 'sec' axis
of a ('dp', 'sec') mesh (`parallel/mesh.py`) shares out. Each rank of a
'sec' group owns Lc / sec contiguous column blocks:

  * beta, s, tau and psi are sharded by column block; the residual z and
    the row statistics phi are replicated across the group
  * forward A beta: each rank runs its own blocks' products (`_fwd_blocks`,
    K1 on a card), sums them by row block, and the partial (B, n) products
    are summed with one all_reduce over 'sec'
  * adjoint A^T z: from the replicated z alone, no communication
  * gamma = W psi / Lc: an all_reduce of the local W_loc psi_loc
  * the stop test: an all_reduce(MIN) of each codeword's flag "every
    local section has settled"

The iteration itself is `models.sparc.amp_decode`'s, given this rank's
shard and its 'sec' group, so the stop rule, the freeze and the fused
denoiser tail K3 are the unsharded decoder's. The 'dp' axis shares out the
trials. The message bits of global column block c of a trial with seed s
come from `root_generator(derive(s, BITS, c))`, its noise from
`root_generator(derive(s, CHANNEL))`, so a trial does not depend on the
layout. Every base matrix with the same number of nonzero blocks in each
column takes this path (spatial coupling: omega per column; plain and
power-allocated codes: one), real or complex, K=1 or K-PSK.

`ShardedDesign` is the column-major view of the one `SparcDesign` of the
seed: the same leaves, permuted so that each shard's blocks are
contiguous, so the operator is the unsharded design's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DecodeParams, SparcParams, create_base_matrix
from ..device import all_reduce
from ..models.sparc import amp_decode, awgn_channel
from ..ops.transforms import SparcDesign
from ..utils import bits as bitops
from ..utils import rng as rngmod
from .mesh import axis, mesh_device


class ShardedDesign:
    """Column-major view of `SparcDesign.for_params(params, awgn_var, seed)`.

    idx, signs, scale (tensors on `device`) and rows, cols (int32 numpy) are
    the design's leaves in `np.lexsort((rows, cols))` order; each column
    holds `blocks_per_col` nonzero blocks. `shard(i, n)` is the design of
    the i-th of n contiguous groups of column blocks.
    """

    def __init__(self, params: SparcParams, awgn_var: float, seed, device=None):
        W = create_base_matrix(params, awgn_var)
        design = SparcDesign.build(W, params.L, params.M, params.codeword_length(),
                                   seed, device)
        rows = np.asarray(design.rows, np.int32)
        cols = np.asarray(design.cols, np.int32)
        order = np.lexsort((rows, cols))
        rows, cols = rows[order], cols[order]
        per_col = np.bincount(cols, minlength=design.Lc)
        if not np.all(per_col == per_col[0]):
            raise ValueError("section sharding needs equal nonzero blocks per column")
        self.blocks_per_col = int(per_col[0])
        self.W, self.params, self.design = W, params, design
        self.Lr, self.Lc, self.Mr, self.Mc = design.Lr, design.Lc, design.Mr, design.Mc
        self.w, self.n = design.w, design.n
        self.rows, self.cols = rows, cols
        perm = torch.as_tensor(order, device=design.device)
        self.idx = design.idx[perm]
        self.signs = design.signs[perm]
        self.scale = design.scale[perm]

    def shard(self, i: int, n: int) -> SparcDesign:
        """The design of column blocks [i Lc/n, (i+1) Lc/n): its blocks'
        leaves, their (global) rows, their cols counted from the shard's
        first column block, Lc/n column blocks."""
        if self.Lc % n:
            raise ValueError(f"the sec axis {n} must divide Lc={self.Lc}")
        lc = self.Lc // n
        e = lc * self.blocks_per_col
        sl = slice(i * e, (i + 1) * e)
        return self.design.with_leaves(
            self.idx[sl], self.signs[sl], self.scale[sl],
            rows=tuple(int(r) for r in self.rows[sl]),
            cols=tuple(int(c) - i * lc for c in self.cols[sl]),
            Lc=lc, LM=lc * self.Mc)


class ShardedSimStep:
    """The ('dp', 'sec')-sharded Monte Carlo step of one configuration
    (`make_sharded_sim_step`). Every rank of the mesh makes the same calls.

    run(seeds): the trials of `seeds` (one seed per trial; padded to the dp
    axis, padded trials decode nothing), dp rank r taking the r-th
    contiguous share; returns {bit_errs, sec_errs, frame_errs, iter_sum},
    the same on every rank.
    decode(y): AMP on given received words y (B, n), the same on every
    rank; returns (hard decisions (B, L*M), iterations (B,)), as
    `models.sparc.decode_batch` does, on every rank.
    """

    def __init__(self, params: SparcParams, decode: DecodeParams, awgn_var: float,
                 mesh, seed=0, fwht_mode: str = "ms"):
        self.device = mesh_device(mesh)
        self.params, self.decode_params, self.awgn_var = params, decode, awgn_var
        self.n_dp, self.dp_rank, self.dp_group = axis(mesh, "dp")
        self.n_sec, self.sec_rank, self.sec_group = axis(mesh, "sec")
        self.sd = ShardedDesign(params, awgn_var, seed, self.device)
        self.local = self.sd.shard(self.sec_rank, self.n_sec)
        self.Lc_loc = self.local.Lc
        self.col0 = self.sec_rank * self.Lc_loc
        self.sec_per_col = params.L // self.sd.Lc
        self.bits_per_col = self.sec_per_col * params.sec_size
        W = torch.as_tensor(self.sd.W, dtype=torch.float32, device=self.device)
        self.W_loc = W[:, self.col0:self.col0 + self.Lc_loc].contiguous()
        self.cdtype = torch.complex64 if params.is_complex else torch.float32
        self.fwht_mode = fwht_mode

    def __call__(self, seeds):
        return self.run(seeds)

    def _share(self, n: int):
        per = -(-n // self.n_dp)
        return min(self.dp_rank * per, n), min((self.dp_rank + 1) * per, n)

    def _ab(self, beta_loc: torch.Tensor) -> torch.Tensor:
        """The replicated A beta from this rank's column blocks."""
        return all_reduce(self.local.ab(beta_loc, fwht_mode=self.fwht_mode),
                          self.sec_group)

    def decode(self, y: torch.Tensor):
        p = self.params
        B = y.shape[0]
        lo, hi = self._share(B)
        c0, c1 = self.col0 * self.sd.Mc, (self.col0 + self.Lc_loc) * self.sd.Mc
        dtype = torch.complex64 if p.K > 2 else torch.float32
        beta = torch.zeros(B, p.L * p.M, dtype=dtype, device=self.device)
        t_final = torch.zeros(B, dtype=torch.int64, device=self.device)
        if hi > lo:
            res = amp_decode(y[lo:hi].to(self.device, self.cdtype), self.local, p,
                             self.decode_params, self.awgn_var, W=self.W_loc,
                             fwht_mode=self.fwht_mode, sec_group=self.sec_group)
            beta[lo:hi, c0:c1] = res.beta
            if self.sec_rank == 0:
                t_final[lo:hi] = res.t_final
        for group in (self.sec_group, self.dp_group):
            all_reduce(beta, group)
            all_reduce(t_final, group)
        return beta, t_final

    def run(self, seeds) -> dict:
        p, dev = self.params, self.device
        M, K, lc = p.M, p.K, self.Lc_loc
        lo, hi = self._share(len(seeds))
        out = torch.zeros(4, dtype=torch.int64, device=dev)
        if hi > lo:
            mine = list(seeds[lo:hi])
            bits = torch.stack([torch.stack([
                bitops.random_bits(rngmod.root_generator(
                    rngmod.derive(sd_, rngmod.BITS, self.col0 + c), dev),
                    self.bits_per_col) for c in range(lc)]) for sd_ in mine])
            beta0 = bitops.bits_to_msg_vector(bits, M, K).reshape(len(mine), -1) \
                .to(self.cdtype)
            x = self._ab(beta0)
            y = torch.stack([awgn_channel(xi, self.awgn_var, rngmod.root_generator(
                rngmod.derive(sd_, rngmod.CHANNEL), dev)) for xi, sd_ in zip(x, mine)])
            res = amp_decode(y, self.local, p, self.decode_params, self.awgn_var,
                             W=self.W_loc, fwht_mode=self.fwht_mode,
                             sec_group=self.sec_group)
            beta_map, t_final = res.beta, res.t_final
            bits_out = bitops.msg_vector_to_bits(beta_map.reshape(len(mine), lc, -1), M, K)
            be = all_reduce((bits != bits_out).sum((1, 2)), self.sec_group)
            se = all_reduce((beta_map != beta0).reshape(len(mine), -1, M).any(-1).sum(-1),
                            self.sec_group)
            out += torch.stack([be.sum(), se.sum(), (be > 0).sum(), t_final.sum()])
        all_reduce(out, self.dp_group)
        be, se, fe, it = out.tolist()
        return {"bit_errs": be, "sec_errs": se, "frame_errs": fe, "iter_sum": it}


def make_sharded_sim_step(params: SparcParams, decode: DecodeParams, awgn_var: float,
                          mesh, seed=0, **kw):
    """The ('dp', 'sec')-sharded Monte Carlo step of design seed `seed` on
    `mesh`: (step, n_dp), where step(seeds) runs one trial per seed and
    step.decode(y) decodes given words (`ShardedSimStep`); kw: fwht_mode
    ("ms", K1, or "2mm" / "2mm_f32", K2, as in `models.sparc.amp_decode`)."""
    step = ShardedSimStep(params, decode, awgn_var, mesh, seed, **kw)
    return step, step.n_dp
