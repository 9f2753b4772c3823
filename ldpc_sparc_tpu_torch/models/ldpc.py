"""IEEE 802.11n / 802.16 LDPC code library, in PyTorch.

Counterpart of `ldpc_sparc_tpu/models/ldpc.py` (the reference's `code`
class, ldpc_jossy/py/ldpc.py:4-503):

  * protograph tables from models/ldpc_tables.py (standard constants)
  * parity-check expansion `pcmat` (ldpc.py:275-300)
  * the flat-graph preparation (vdeg/cdeg/intrlv) of the reference's C
    decoder, in closed form: the check-side port of an edge is the rank of
    its column among the nonzero columns of its row, and the variable-side
    port the rank of its row among the nonzero rows of its column
  * a systematic encoder: the dual-diagonal parity chain (ldpc.py:400-460)
    run once at build time on the K unit vectors gives the parity generator
    Gp (K, N-K); encoding is then one product `(info @ Gp) mod 2`
  * decode: BP (ops/bp.py), through the hand-written kernel on a card

All of the above but `encode` and `decode` is host-side numpy, held
bit-identical to the JAX package's by `tests/test_torch_ldpc.py`. Tensors
go to a device on demand and are cached per device. `decode_ref`, `Lxor`
and `Lxfb` call the port's own float64 C++ oracle (`native/oracle.py`),
which K4 is held to on the card.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..config import LdpcParams
from ..ops.bp import BpResult, TannerGraph, bp_decode
from .ldpc_tables import get_protograph


class LdpcCode:
    """One (standard, rate, z, ptype) LDPC code with encoder and decoder."""

    def __init__(self, params: LdpcParams):
        self.params = params
        self.proto = get_protograph(params.standard, params.rate, params.z,
                                    params.ptype)
        self.z = params.z
        self.Mp, self.Np = self.proto.shape
        self.Kp = self.Np - self.Mp
        self.N = self.Np * self.z      # codeword length (Nv)
        self.K = self.Kp * self.z      # information length
        self.graph = TannerGraph.build(self.proto, self.z)
        self._gp_on = {}               # device -> the generator there
        self._prepare_flat_graph()
        self._prepare_encoder()

    # ------------------------------------------------------------------
    # flat-graph representation (oracle ABI + structural tests)
    # ------------------------------------------------------------------
    def _prepare_flat_graph(self):
        proto, z = self.proto, self.z
        nz = proto != -1
        self.cdeg = np.repeat(nz.sum(1), z).astype(np.int64)   # (Nc,)
        self.vdeg = np.repeat(nz.sum(0), z).astype(np.int64)   # (Nv,)
        cumc = np.insert(np.cumsum(self.cdeg), 0, 0)
        cumv = np.insert(np.cumsum(self.vdeg), 0, 0)

        xp, yp = np.nonzero(nz)                    # row-major edge order
        shifts = proto[xp, yp] % z
        # rank of this edge's column among nonzero columns of its row
        col_rank = np.concatenate([np.arange(n) for n in nz.sum(1)])
        # rank of this edge's row among nonzero rows of its column
        row_rank = np.zeros_like(xp)
        for j in range(self.Np):
            ids = np.flatnonzero(yp == j)
            order = np.argsort(xp[ids], kind="stable")
            row_rank[ids[order]] = np.arange(ids.size)

        k = np.arange(z)
        cind = xp[:, None] * z + k[None, :]                      # (E, z)
        vind = yp[:, None] * z + (k[None, :] + shifts[:, None]) % z
        cpos = cumc[cind] + col_rank[:, None]
        vpos = cumv[vind] + row_rank[:, None]
        intrlv = np.empty(int(self.cdeg.sum()), dtype=np.int64)
        intrlv[vpos.ravel()] = cpos.ravel()
        self.intrlv = intrlv                       # var-order pos -> chk pos
        self.Nv, self.Nc, self.Nmsg = self.N, self.Mp * z, intrlv.size

    def pcmat(self) -> np.ndarray:
        """Dense parity-check matrix: each nonzero protograph entry expands
        to a z x z identity cyclically shifted by the entry (ldpc.py:275-300)."""
        proto, z = self.proto, self.z
        H = np.zeros((z * self.Mp, z * self.Np), dtype=int)
        I = np.eye(z, dtype=int)
        for i, j in zip(*np.nonzero(proto != -1)):
            H[i * z:(i + 1) * z, j * z:(j + 1) * z] = \
                np.roll(I, proto[i, j] % z, axis=1)
        return H

    # ------------------------------------------------------------------
    # systematic encoder
    # ------------------------------------------------------------------
    def _prepare_encoder(self):
        """The dual-diagonal encoder (ldpc.py:400-460) as a generator matrix,
        computed by running the parity chain on the K unit vectors."""
        proto, z, Kp, Mp = self.proto, self.z, self.Kp, self.Mp
        # systematic accumulation: p[j] = XOR_k roll(x[k], -proto[j,k])
        self._sys_edges = [(j, k, int(proto[j, k]))
                           for j in range(Mp) for k in range(Kp)
                           if proto[j, k] != -1]
        # first parity column Kp: shifts come in pairs except one
        toff = np.zeros(z, dtype=int)
        for j in np.flatnonzero(proto[:, Kp] != -1):
            toff[proto[j, Kp] % z] += 1
        tnz = np.flatnonzero(toff % 2)
        if tnz.size != 1:
            raise ValueError("column Kp offsets do not reduce to one offset")
        self._toff = int(tnz[0])
        # back-substitution: x[Kp+j+1] = p[j] XOR_k roll(x[Kp+k], -shift)
        self._bs_edges = [
            [(Kp + k, int(proto[j, Kp + k]))
             for k in np.flatnonzero(proto[j, Kp:Kp + j + 1] != -1)]
            for j in range(Mp - 1)]
        # parity generator: row i = parity bits of unit info word e_i. The
        # product runs on float32 0/1 operands with float32 accumulation:
        # every dot product is an integer <= K < 2^24, so it is exact (also
        # under TF32, whose 10-bit mantissa holds 0 and 1 exactly).
        assert self.K < (1 << 24), \
            "matmul encoder exactness requires K < 2^24 (f32 accumulator)"
        self._Gp = self.parity_chain(np.eye(self.K, dtype=np.int64)).astype(
            np.float32)

    def parity_chain(self, info: np.ndarray) -> np.ndarray:
        """Reference dual-diagonal parity chain (ldpc.py:400-460), batched
        numpy. info: (B, K) {0,1} -> (B, N-K). Build-time generator
        construction and the oracle for testing the matmul encoder."""
        z, Kp, Mp = self.z, self.Kp, self.Mp
        xs = info.reshape(-1, Kp, z)
        p = np.zeros((xs.shape[0], Mp, z), np.int64)
        for j, k, shift in self._sys_edges:
            p[:, j] += np.roll(xs[:, k], -shift, axis=-1)
        p %= 2
        tp = p.sum(axis=1) % 2
        parity = [np.roll(tp, self._toff, axis=-1)]
        for j in range(Mp - 1):
            acc = p[:, j].copy()
            for col, shift in self._bs_edges[j]:
                acc = acc + np.roll(parity[col - Kp], -shift, axis=-1)
            parity.append(acc % 2)
        return np.concatenate(parity, axis=-1)

    def generator(self, device) -> torch.Tensor:
        """The parity generator Gp (K, N-K) float32 on `device`, cached."""
        device = torch.device(device)
        if device not in self._gp_on:
            self._gp_on[device] = torch.as_tensor(self._Gp, device=device)
        return self._gp_on[device]

    def encode(self, info) -> torch.Tensor:
        """Systematic encoding. info: (..., K) {0,1} -> (..., N) int32 on
        info's device; bit-identical to the reference's super-symbol chain
        (ldpc.py:400-460), asserted against `parity_chain` in the tests."""
        info = torch.as_tensor(info)
        assert info.shape[-1] == self.K
        acc = torch.matmul(info.to(torch.float32), self.generator(info.device))
        parity = acc.to(torch.int32) % 2
        return torch.cat([info.to(torch.int32), parity], dim=-1)

    # ------------------------------------------------------------------
    # decoder
    # ------------------------------------------------------------------
    def decode(self, ch, max_itcount: int = 200, dectype: str = "sumprod2",
               corr_factor: float = 0.7, bp_kernel: bool = True) -> BpResult:
        """BP decode of channel LLRs (API of ldpc.py:463-490).

        ch: (..., N) LLRs. Returns (app, iterations). dectype 'minsum' takes
        min-sum, anything else sum-product. bp_kernel: see ops/bp.bp_decode.
        """
        method = "minsum" if dectype == "minsum" else "sumprod"
        ch = torch.as_tensor(ch, dtype=torch.float32)
        return bp_decode(ch, self.graph, max_iters=max_itcount, method=method,
                         corr_factor=corr_factor, bp_kernel=bp_kernel)

    def Lxor(self, L1: float, L2: float, corrflag: int = 1) -> float:
        """Pairwise LLR-XOR via the native oracle (API of ldpc.py:492-495)."""
        from ..native import oracle
        return oracle.lxor(float(L1), float(L2), corrflag)

    def Lxfb(self, L, corrflag: int = 1):
        """Extrinsic LLRs via the native oracle (API of ldpc.py:497-503).
        Returns (aggregate, extrinsic_array)."""
        from ..native import oracle
        return oracle.lxfb(np.asarray(L, np.float64), corrflag)

    def decode_ref(self, ch: np.ndarray, max_itcount: int = 200,
                   dectype: str = "sumprod2",
                   corr_factor: float = 0.7) -> Tuple[np.ndarray, int]:
        """Decode one codeword through the native float64 C++ oracle (a port
        of the reference's c_ldpc.c). Returns (app, iterations)."""
        from ..native import oracle
        return oracle.decode(np.asarray(ch, np.float64), self.vdeg, self.cdeg,
                             self.intrlv, max_itcount, dectype, corr_factor)


@functools.lru_cache(maxsize=64)
def get_code(standard: str, rate: str, z: int, ptype: str = "A") -> LdpcCode:
    """Cached code constructor (graph prep is host-side work worth sharing)."""
    return LdpcCode(LdpcParams(standard=standard, rate=rate, z=z, ptype=ptype))
