"""Carry a design built by the JAX package into the port.

A SPARC design (its index sets, sign diagonals and block scales) is the
state that both packages must share to compute the same products: it is
what weights are to a model. These helpers take the JAX `SparcDesign`'s
leaves as numpy arrays (`np.asarray(d.idx)`, `np.asarray(d.signs)`,
`np.asarray(d.scale)`) and the static fields of its `tree_flatten`
(rows, cols, Lr, Lc, Mr, Mc, w, n, LM, offset), and build the port's
`SparcDesign` from them; `dft_design_from_numpy` does the same for a JAX
`DftDesign` (leaves rows, cols; static w, n, LM, scale). Nothing here
imports JAX.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .ops.transforms import DftDesign, SparcDesign


def design_from_numpy(idx: np.ndarray, signs: np.ndarray, scale: np.ndarray,
                      meta: Sequence, device="cpu") -> SparcDesign:
    """A port design from leaf arrays and the static fields
    (rows, cols, Lr, Lc, Mr, Mc, w, n, LM, offset)."""
    rows, cols, Lr, Lc, Mr, Mc, w, n, LM, offset = meta
    return SparcDesign(
        torch.tensor(np.asarray(idx), dtype=torch.int64, device=device),
        torch.tensor(np.asarray(signs), dtype=torch.float32, device=device),
        torch.tensor(np.asarray(scale), dtype=torch.float32, device=device),
        tuple(int(r) for r in rows), tuple(int(c) for c in cols),
        int(Lr), int(Lc), int(Mr), int(Mc), int(w), int(n), int(LM), int(offset))


def design_from_jax_leaves(leaves: Sequence, aux: Sequence,
                           device="cpu") -> SparcDesign:
    """A port design from `jax_design.tree_flatten()`'s (leaves, aux); the
    leaves may be JAX arrays, they are read through `np.asarray`."""
    idx, signs, scale = (np.asarray(leaf) for leaf in leaves)
    return design_from_numpy(idx, signs, scale, aux, device)


def dft_design_from_numpy(rows: np.ndarray, cols: np.ndarray, meta: Sequence,
                          device="cpu") -> DftDesign:
    """A port `DftDesign` from the JAX `DftDesign`'s leaves (rows, cols) and
    the static fields of its `tree_flatten` (w, n, LM, scale)."""
    w, n, LM, scale = meta
    return DftDesign(torch.tensor(np.asarray(rows), dtype=torch.int64, device=device),
                     torch.tensor(np.asarray(cols), dtype=torch.int64, device=device),
                     int(w), int(n), int(LM), float(scale))
