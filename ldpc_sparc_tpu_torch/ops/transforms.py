"""Seeded Hadamard SPARC design operator (SRHT form).

Counterpart of `ldpc_sparc_tpu/ops/transforms.py`; see that module for the
ensemble. Each nonzero base-matrix block (r, c) is a sqrt(W[r,c]/L)-scaled
subsampled randomized Hadamard transform: a random, sorted index set on the
smaller side of the block and a contiguous window [offset, offset + dim)
with a random +-1 sign diagonal on the larger side. The host-side draw of
that randomness (`block_draws`, and `generate_block_randomness` with the
signs made) is a numpy copy of the JAX package's that reads the same seeded
stream in the same order, so the two packages construct bit-identical
designs from one seed. Each block's signs are read as the stream's raw
words (what `rng.integers(0, 2, large)` would take), and turned into +-1
by `signs_from_words` wherever the design goes.

FWHT routing in `srht_apply`: on a CUDA tensor every width-w transform goes
through the hand-written kernel K1 (`ops/wht_cuda`). An offset-0 design
(the window is the whole width) takes K1's two fused products,
`srht_scatter_fwht` and `srht_fwht_gather`: the sign diagonal, the scatter
of the index side into the transform's input and the gather from its
output all happen on chip, so the index side never exists at full width
in device memory. An offset-1 design slices or pads the window around a
`fwht_signed` call without signs. On a CPU tensor the same calls run the
plain versions (zero fill, `scatter_`, the Kronecker chain of
`ops/wht.py`, `gather`). `fwht_kernel=False` takes the plain versions on
any device; they are the reference the kernel path is measured against.

Block-indexed route in `SparcDesign.ab` / `.az`: a design of several
blocks selects each block's input from its column block and sums the
blocks' outputs by row block, and the other way round. On the window side
(the columns of a design that is not tall) both fold into K1 through the
design's column segment table (`segment_table`): `ab` reads each block's
rows from its column block by index (`srht_fwht_gather_blocks`), and `az`
adds each column block's blocks in ascending block order as it stores
(`srht_scatter_fwht_sum`), so no (B, E, w) tensor is made and no float
atomic adds. The route is taken where `window_block_route` says so, by
what the design and the values show: real values on a CUDA device,
`fwht_mode="ms"` with the kernel on, a full offset-0 window of at most
2^15 (K1's block route), a design that is not tall, and columns that are
not the identity. Everything else keeps the select, the per-block
`srht_apply` and the `index_add_` segment sum: one-block designs and
`DesignStack`, tall (power-allocated) designs, windows of 2^16 and up,
offset-1 windows, complex values, K2's modes, the CPU. The row side's
select and sum (small: k values a block) stay `index_select` and
`index_add_` on both routes.

`fwht_mode` picks the transform, as the JAX package's `set_fwht_backend`
mode and dtype do: "ms" (the default) is K1, float32 throughout; "2mm" is
K2 (`ops/wht_cuda.fwht_signed_2mm`), the two-sided H_a . X . H_b form with
bf16 operands, whose plain version rounds where the kernel does;
"2mm_f32" is K2 with float32 operands (JAX's mode "2mm" with dtype
"float32"). "2mm" and "2mm_f32" take K2 only where the JAX package routes
its Pallas kernel (`wht_pallas.use_pallas_srht`): a full offset-0 window
of width 2^14 to 2^20. Every other transform stays float32 (K1), as it
does there. The port's K1 is float32 in every mode, so JAX's dtype knob
has no other counterpart.

Products take leading batch dimensions: `ab` maps (..., L*M) to (..., n)
and `az` maps (..., n) to (..., L*M), with one transform call per product
for the whole batch.

Complex values (complex and K-PSK codes, K >= 4) go through the same real
transforms: `srht_apply` stacks the real rows, then the imaginary rows,
into one real batch of twice the rows and makes one transform call (K1's
sign rule `signs[r % E]` serves it unchanged, since the row count stays a
multiple of E), then joins the two halves. Complex data never takes K2:
the JAX package's Pallas routing refuses complex input
(`wht_pallas.use_pallas_srht`), so "2mm" keeps the float32 transform there.

`DesignStack` is the Monte Carlo's "one design per trial": D one-block
designs of one shape laid along `srht_apply`'s block axis, so that one
product serves a batch of D rows, row t through design t.

`DftDesign` is the second design engine, the reference's exact complex
subsampled-DFT ensemble, for complex plain codes (`engine="dft"`). Its
products are `torch.fft.fft` calls, as the JAX package's are `jnp.fft`
calls outside any Pallas kernel.

A seeded design is made in two steps. `draw_for_params` (and
`SparcDesign.draw`) draws it on the host, checks its index set there and
returns a `HostDesign`: the tensor leaves (for an SRHT design the signs'
words, half the bytes of the signs), pinned where they are bound for a
card, and the static fields. Nothing of it touches a device, so any thread
may draw. `HostDesign.upload` copies the leaves to the device with
`non_blocking` on the current stream and makes the design there
(`from_leaves`), without a host sync. `for_params` and `build` are the two
steps in one.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .wht_cuda import (ROUTE_LOG_W, fwht_signed, fwht_signed_2mm,
                       fwht_signed_2mm_ref, fwht_signed_ref, srht_fwht_gather,
                       srht_fwht_gather_blocks, srht_fwht_gather_ref,
                       srht_scatter_fwht, srht_scatter_fwht_ref,
                       srht_scatter_fwht_sum)
from ..config import SparcParams, create_base_matrix
from ..device import resolve_device

FWHT_MODES = ("ms", "2mm", "2mm_f32")
# log2 widths at which "2mm" and "2mm_f32" take K2: the JAX package's Pallas
# bounds (wht_pallas._MIN_LOG_W, _MAX_LOG_W)
K2_SRHT_LOG_W = (14, 20)


def fwht_transform(fwht_mode: str = "ms", fwht_kernel: bool = True):
    """The signed-FWHT function srht_apply calls: K1 ("ms") or K2 with bf16
    ("2mm") or float32 ("2mm_f32") operands, or their plain versions when
    fwht_kernel is False."""
    if fwht_mode == "ms":
        return fwht_signed if fwht_kernel else fwht_signed_ref
    if fwht_mode in ("2mm", "2mm_f32"):
        fn = fwht_signed_2mm if fwht_kernel else fwht_signed_2mm_ref
        if fwht_mode == "2mm_f32":
            fn = functools.partial(fn, mm_dtype="float32")
        return fn
    raise ValueError(f"fwht_mode must be one of {FWHT_MODES}, got {fwht_mode!r}")


def window_block_route(device_type: str, fwht_kernel: bool, fwht_mode: str,
                       is_complex: bool, offset: int, window: int, w: int,
                       tall: bool, identity: bool) -> bool:
    """Whether a `SparcDesign` product takes K1's block-indexed route, from
    what the values and the design show: values on a CUDA device, real, K1
    ("ms", the kernel on); a full offset-0 window (`window` == w) on K1's
    block route (w <= 2^15); a design that is not tall (its window side is
    its columns); and columns whose segments are not the identity (some
    column block holds more than one block, or a block lies elsewhere than
    its own)."""
    return (device_type == "cuda" and fwht_kernel and fwht_mode == "ms"
            and not is_complex and offset == 0 and window == w
            and w.bit_length() - 1 <= ROUTE_LOG_W["block"][1] and not tall
            and not identity)


def _segment_array(seg: tuple, num: int) -> np.ndarray:
    """`segment_table`'s (num + 1 + E,) int32 host array, ptr then blocks."""
    seg = np.asarray(seg, dtype=np.int64).reshape(-1)
    if seg.size and not (seg.min() >= 0 and seg.max() < num):
        raise ValueError(f"segment ids outside [0, {num})")
    ptr = np.zeros(num + 1, dtype=np.int32)
    ptr[1:] = np.cumsum(np.bincount(seg, minlength=num))
    blocks = np.argsort(seg, kind="stable").astype(np.int32)
    return np.concatenate([ptr, blocks])


def segment_table(seg: tuple, num: int, device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ptr (num + 1,), blocks (E,)) int32 on `device`, two views of one
    upload: segment s holds the blocks e with seg[e] == s, ascending, as
    blocks[ptr[s]:ptr[s + 1]]. Raises on a segment id outside [0, num)."""
    table = torch.as_tensor(_segment_array(seg, num), device=device)
    return table[:num + 1], table[num + 1:]


def _check_index_range(idx, w: int) -> None:
    """Raise unless every entry of `idx` (a numpy array or a tensor) lies in
    [0, w). On a device tensor this reads the device back."""
    if math.prod(idx.shape) and not (int(idx.min()) >= 0 and int(idx.max()) < w):
        raise ValueError(f"idx has entries outside [0, {w})")


@dataclass(eq=False)
class HostDesign:
    """A design drawn on the host: `cls` (`SparcDesign` or `DftDesign`),
    its tensor leaves by field name (pinned where they are bound for a
    card) and its static fields."""

    cls: type
    leaves: dict
    static: dict

    @classmethod
    def of(cls, design_cls: type, arrays: dict, static: dict,
           pin: bool) -> "HostDesign":
        """The host design of numpy `arrays`, copied into pinned memory when
        `pin` (the card's side of a copy without a host sync)."""
        leaves = {k: torch.from_numpy(np.ascontiguousarray(a))
                  for k, a in arrays.items()}
        if pin:
            leaves = {k: t.pin_memory() for k, t in leaves.items()}
        return cls(design_cls, leaves, static)

    def upload(self, device) -> "SparcDesign | DftDesign":
        """The design on `device`. Each leaf is copied with `non_blocking` on
        the current stream, the stream its products run on after it, so
        from pinned leaves no copy waits for the device; what the design
        computes from them (`from_leaves`) is queued on the same stream. On
        the CPU the design holds the leaves themselves."""
        device = torch.device(device)
        return self.cls.from_leaves({k: t.to(device, non_blocking=True)
                                     for k, t in self.leaves.items()}, self.static)


def _next_pow2_at_least(x: int) -> int:
    return 1 << (x - 1).bit_length()


def _sign_words(bitgen, count: int) -> Tuple[int, np.ndarray]:
    """Take from `bitgen` (PCG64) what `Generator.integers(0, 2, count)`
    takes, and return it as (held, words). That call makes `count` 32-bit
    draws (`next_uint32`: the half of a 64-bit output that the state holds
    from an earlier 32-bit draw, if any, then the low and the high half of
    each next output; a high half left over stays held) and keeps each
    one's top bit (Lemire's bound with two outcomes rejects nothing).
    held: the held half it starts from, or -1; words: the (ceil((count -
    [held]) / 2),) uint64 outputs. The state is left as that call leaves
    it, so the stream goes on unchanged."""
    state = bitgen.state
    held = state["uinteger"] if state["has_uint32"] else -1
    words = bitgen.random_raw((count - (held >= 0) + 1) // 2)
    left = 2 * len(words) - (count - (held >= 0))
    if held >= 0 or left:
        state = bitgen.state
        state["has_uint32"] = left
        state["uinteger"] = int(words[-1] >> np.uint64(32)) if left else 0
        bitgen.state = state
    return held, words


def signs_from_words(words: torch.Tensor, held: torch.Tensor,
                     count: int) -> torch.Tensor:
    """The (E, count) float32 +-1 signs of `block_draws`' words ((E,
    ceil(count / 2)) int64, the uint64 outputs' bits, a shorter row padded)
    and held halves ((E,) int64): row e's 32-bit draws are its held half,
    if any, then the low and the high half of each word; a draw's top bit
    b gives the sign 2b - 1. Plain torch ops on the words' device, which
    the card runs without a host sync."""
    # a little-endian int32 view holds each word's low, then high half; a
    # half's top bit is the view's sign
    top = torch.cat([(held >= 1 << 31)[:, None], words.view(torch.int32) < 0], dim=1)
    top = torch.where((held >= 0)[:, None], top[:, :count], top[:, 1:count + 1])
    return torch.where(top, 1.0, -1.0)


def block_draws(W: np.ndarray, Mr: int, Mc: int, w: int, seed,
                offset: int = 1) -> Tuple[np.ndarray, ...]:
    """Per-nonzero-block randomness for the SRHT blocks, visited row-major
    with one seeded stream: for each block, first the sorted index set
    `rng.choice(base, small, replace=False)`, then the signs
    `rng.integers(0, 2, large)`. Any other order changes the design.

    Returns (rows, cols, idx, words, held):
      rows, cols : (E,) int32 block coordinates of the E nonzero blocks
      idx        : (E, min(Mr, Mc)) int32 sorted H_w indices for the small
                   side
      words, held: the signs of the large (window) side as the stream's
                   words, (E, ceil(large / 2)) uint64 (a row shorter by one
                   padded with 0), and (E,) int64 held halves
                   (`_sign_words`, `signs_from_words`)
    Per block the stream is read by two calls and nothing else: the sorts
    run once over all blocks, and the words become signs where the design
    goes (`signs_from_words`; on the card for an upload). So a thread that
    draws holds the interpreter's lock for little of its time.
    """
    rng = np.random.default_rng(seed)
    small, large = min(Mr, Mc), max(Mr, Mc)
    if offset == 0:
        # full window [0, w): every index is a candidate
        Q = w
        base = np.arange(0, Q, dtype=np.int32)
    else:
        # candidates in [1, Q) with Q = 2^floor(log2(large)), so that any two
        # indices differ in a bit the window [1, large+1) covers densely;
        # widened only when the block needs more than Q-1 indices
        Q = 1 << int(np.floor(np.log2(large)))
        while Q <= small:
            Q *= 2
        Q = min(Q, w)
        base = np.arange(1, Q, dtype=np.int32)
    rows, cols = (a.astype(np.int32) for a in np.nonzero(W))   # row-major
    draws = [(rng.choice(base, small, replace=False),
              _sign_words(rng.bit_generator, large)) for _ in range(len(rows))]
    idx = np.sort(np.stack([i for i, _ in draws]), axis=1)
    held = np.array([h for _, (h, _) in draws], dtype=np.int64)
    n = (large + 1) // 2
    if all(len(ws) == n for _, (_, ws) in draws):
        words = np.stack([ws for _, (_, ws) in draws])
    else:                                   # odd `large`: some rows one short
        words = np.zeros((len(rows), n), dtype=np.uint64)
        for row, (_, (_, ws)) in zip(words, draws):
            row[:len(ws)] = ws
    return rows, cols, idx, words, held


def generate_block_randomness(W: np.ndarray, Mr: int, Mc: int, w: int,
                              seed, offset: int = 1
                              ) -> Tuple[np.ndarray, np.ndarray,
                                         np.ndarray, np.ndarray]:
    """`block_draws` with the signs made on the host: (rows, cols, idx,
    signs), signs the (E, max(Mr, Mc)) float32 +-1 diagonal of the large
    (window) side."""
    rows, cols, idx, words, held = block_draws(W, Mr, Mc, w, seed, offset)
    signs = signs_from_words(torch.from_numpy(words.view(np.int64)),
                             torch.from_numpy(held), max(Mr, Mc))
    return rows, cols, idx, signs.numpy()


def srht_apply(vals: torch.Tensor, idx: torch.Tensor, signs: torch.Tensor,
               w: int, in_dim: int, out_dim: int, idx_side_is_input: bool,
               offset: int = 1, scale: torch.Tensor | None = None,
               fwht_kernel: bool = True, fwht_mode: str = "ms",
               idx32: torch.Tensor | None = None) -> torch.Tensor:
    """Per-block SRHT product, (..., E, in_dim) -> (..., E, out_dim).

    idx_side_is_input: the random index set addresses the input (scatter in)
    or the output (gather out); the other side is the signed window
    [offset, offset + dim). scale: optional (E,) per-block multipliers,
    applied on the small (index) side, where they cost O(small). idx32:
    an int32 copy of idx for K1's fused products, which otherwise make one
    per call on a card. Complex vals: their real and imaginary parts as one
    stacked real batch through the float32 transform (never K2).
    """
    transform = fwht_transform(fwht_mode, fwht_kernel)
    if vals.is_complex():
        parts = srht_apply(torch.stack([vals.real, vals.imag]), idx, signs, w,
                           in_dim, out_dim, idx_side_is_input, offset, scale,
                           fwht_kernel, "ms", idx32)
        return torch.complex(parts[0], parts[1])
    window = out_dim if idx_side_is_input else in_dim
    if not (offset == 0 and window == w
            and K2_SRHT_LOG_W[0] <= w.bit_length() - 1 <= K2_SRHT_LOG_W[1]):
        transform = fwht_transform("ms", fwht_kernel)
    E = idx.shape[0]
    batch = vals.shape[:-2]
    x = vals.reshape(-1, E, in_dim)
    B = x.shape[0]
    if idx_side_is_input:
        if scale is not None:
            x = x * scale[:, None]
        x = x.reshape(B * E, in_dim)
        if offset == 0 and out_dim == w:
            if transform is fwht_signed:
                out = srht_scatter_fwht(x, idx if idx32 is None else idx32, signs,
                                        w, validate=False)
            else:
                out = srht_scatter_fwht_ref(x, idx, signs, w, transform=transform)
            out = out.reshape(B, E, w)
        else:
            Y = srht_scatter_fwht_ref(x, idx, None, w, transform=transform)
            out = Y.reshape(B, E, w)[..., offset:out_dim + offset] * signs
    else:
        if offset == 0 and in_dim == w:
            x = x.reshape(B * E, w)
            if transform is fwht_signed:
                out = srht_fwht_gather(x, signs, idx if idx32 is None else idx32,
                                       validate=False)
            else:
                out = srht_fwht_gather_ref(x, signs, idx, transform=transform)
        else:
            X = F.pad(x * signs, (offset, w - offset - in_dim))
            out = srht_fwht_gather_ref(X.reshape(B * E, w), None, idx,
                                       transform=transform)
        out = out.reshape(B, E, out_dim)
        if scale is not None:
            out = out * scale[:, None]
    return out.reshape(batch + (E, out_dim))


@dataclass(eq=False)
class SparcDesign:
    """Blockwise SRHT design operator.

    Tensors (on one device):
      idx   : (E, min(Mr, Mc)) int64  per-block H_w indices, sorted
      signs : (E, max(Mr, Mc)) float32 per-block +-1 window signs
      scale : (E,) float32 per-block sqrt(W[r,c]/L)
    Static metadata:
      rows/cols : nonzero-block coordinates; shapes Lr, Lc, Mr, Mc, w, n, LM.
      tall      : Mr > Mc (index set on columns) or not (index set on rows).
    The column segment table (`segment_table` of the cols; int32 on the
    design's device) is built with the design, and rebuilt by `with_leaves`
    from a shard's own cols; it is None where the block-indexed route
    cannot use it: a tall design, or columns that are the identity (one
    block a column block, in order: a one-block design uploads nothing
    more).

    `_index` ((2, E) int64, rows then cols) and `_segments` (the column
    segment table's one array) come with leaves uploaded from a
    `HostDesign`, whose index set was checked on the host. Made from
    device tensors without them, the design checks its index set on the
    device (a host sync) and uploads both itself.
    """

    idx: torch.Tensor
    signs: torch.Tensor
    scale: torch.Tensor
    rows: tuple
    cols: tuple
    Lr: int
    Lc: int
    Mr: int
    Mc: int
    w: int
    n: int
    LM: int
    offset: int = 1
    _index: torch.Tensor | None = field(default=None, repr=False)
    _segments: torch.Tensor | None = field(default=None, repr=False)
    _idx32: torch.Tensor = field(init=False, repr=False)
    _rows_t: torch.Tensor = field(init=False, repr=False)
    _cols_t: torch.Tensor = field(init=False, repr=False)
    _col_ptr: torch.Tensor | None = field(init=False, repr=False)
    _col_blocks: torch.Tensor | None = field(init=False, repr=False)

    def __post_init__(self):
        if self._index is None:
            _check_index_range(self.idx, self.w)
            dev = self.signs.device
            index, segments = self._index_arrays(self.rows, self.cols, self.Lc,
                                                 self.tall)
            self._index = torch.as_tensor(index, device=dev)
            self._segments = (None if segments is None
                              else torch.as_tensor(segments, device=dev))
        # the kernels' copy of the index set, checked once
        self._idx32 = self.idx.to(torch.int32)
        self._rows_t, self._cols_t = self._index
        self._col_ptr, self._col_blocks = (
            (None, None) if self._segments is None
            else (self._segments[:self.Lc + 1], self._segments[self.Lc + 1:]))

    @staticmethod
    def _index_arrays(rows: tuple, cols: tuple, Lc: int, tall: bool):
        """(rows and cols as one (2, E) int64 array, the column segment
        table's array or None where the block-indexed route cannot use it)."""
        index = np.array([rows, cols], dtype=np.int64).reshape(2, len(rows))
        identity = tall or cols == tuple(range(Lc))
        return index, None if identity else _segment_array(cols, Lc)

    @property
    def tall(self) -> bool:
        return self.Mr > self.Mc

    @property
    def E(self) -> int:
        return len(self.rows)

    def with_leaves(self, idx, signs, scale=None, **static) -> "SparcDesign":
        """This design with the tensor leaves idx, signs (and scale) replaced,
        carrying every static field (w, offset, the block sides, and so
        `tall`) unless `static` names new values: a shard of the column
        blocks passes its rows, its local cols, Lc and LM. The new leaves
        are checked on their device."""
        return dataclasses.replace(self, idx=idx, signs=signs,
                                   scale=self.scale if scale is None else scale,
                                   _index=None, _segments=None, **static)

    @property
    def device(self) -> torch.device:
        return self.signs.device

    # -- construction -------------------------------------------------------
    @classmethod
    def draw(cls, W: np.ndarray, L: int, M: int, n: int, seed,
             pin: bool = False) -> HostDesign:
        """The operator for base matrix W (2-D (Lr, Lc)), drawn on the host:
        Mr = n/Lr rows and Mc = L*M/Lc columns per block; transform width w
        = the window side when it is a power of two (offset 0), else the
        next power of two with room to skip the all-ones row/column 0
        (offset 1). The index set is checked here; `pin` pins the leaves."""
        W = np.atleast_2d(np.asarray(W, dtype=np.float64))
        Lr, Lc = W.shape
        assert n % Lr == 0, "Lr must divide n"
        assert (L * M) % Lc == 0, "Lc must divide L*M"
        Mr, Mc = n // Lr, (L * M) // Lc
        large = max(Mr, Mc)
        if large & (large - 1) == 0:
            w, offset = large, 0
        else:
            w, offset = _next_pow2_at_least(large + 1), 1
        rows, cols, idx, words, held = block_draws(W, Mr, Mc, w, seed, offset)
        _check_index_range(idx, w)
        rows_t, cols_t = tuple(int(r) for r in rows), tuple(int(c) for c in cols)
        index, segments = cls._index_arrays(rows_t, cols_t, Lc, Mr > Mc)
        arrays = {"idx": idx.astype(np.int64), "words": words.view(np.int64),
                  "held": held,
                  "scale": np.sqrt(W[rows, cols] / L).astype(np.float32),
                  "_index": index}
        if segments is not None:
            arrays["_segments"] = segments
        return HostDesign.of(cls, arrays, {
            "rows": rows_t, "cols": cols_t, "Lr": Lr, "Lc": Lc, "Mr": Mr,
            "Mc": Mc, "w": w, "n": n, "LM": L * M, "offset": offset}, pin)

    @classmethod
    def from_leaves(cls, leaves: dict, static: dict) -> "SparcDesign":
        """The design of `draw`'s leaves, once on their device: the signs
        made there from the stream's words (`signs_from_words`)."""
        leaves = dict(leaves)
        signs = signs_from_words(leaves.pop("words"), leaves.pop("held"),
                                 max(static["Mr"], static["Mc"]))
        return cls(signs=signs, **leaves, **static)

    @classmethod
    def build(cls, W: np.ndarray, L: int, M: int, n: int, seed,
              device=None) -> "SparcDesign":
        """`draw`'s operator uploaded to `device`: the card unless `device`
        says otherwise."""
        device = resolve_device(device)
        return cls.draw(W, L, M, n, seed, device.type == "cuda").upload(device)

    @classmethod
    def draw_for_params(cls, params: SparcParams, awgn_var: float, seed,
                        pin: bool = False) -> HostDesign:
        W = create_base_matrix(params, awgn_var)
        return cls.draw(W, params.L, params.M, params.codeword_length(), seed,
                        pin)

    @classmethod
    def for_params(cls, params: SparcParams, awgn_var: float, seed,
                   device=None) -> "SparcDesign":
        device = resolve_device(device)
        return cls.draw_for_params(params, awgn_var, seed,
                                   device.type == "cuda").upload(device)

    # -- products -----------------------------------------------------------
    def _fwd_blocks(self, vals: torch.Tensor, fwht_kernel: bool = True,
                    fwht_mode: str = "ms"):
        """(..., E, Mc) column-block values -> (..., E, Mr) row-block parts."""
        return srht_apply(vals, self.idx, self.signs, self.w, self.Mc, self.Mr,
                          idx_side_is_input=self.tall, offset=self.offset,
                          scale=self.scale, fwht_kernel=fwht_kernel,
                          fwht_mode=fwht_mode, idx32=self._idx32)

    def _adj_blocks(self, vals: torch.Tensor, fwht_kernel: bool = True,
                    fwht_mode: str = "ms"):
        """(..., E, Mr) row-block values -> (..., E, Mc) column-block parts
        (H symmetric: the adjoint swaps which side is scatter/gather)."""
        return srht_apply(vals, self.idx, self.signs, self.w, self.Mr, self.Mc,
                          idx_side_is_input=not self.tall, offset=self.offset,
                          scale=self.scale, fwht_kernel=fwht_kernel,
                          fwht_mode=fwht_mode, idx32=self._idx32)

    @staticmethod
    def _segment_sum(parts: torch.Tensor, seg: tuple, seg_t: torch.Tensor,
                     num: int) -> torch.Tensor:
        """Sum (B, E, d) block parts into (B, num, d) by segment id."""
        if seg == tuple(range(num)):  # one block per segment, in order
            return parts
        out = parts.new_zeros(parts.shape[0], num, parts.shape[2])
        return out.index_add_(1, seg_t, parts)

    @staticmethod
    def _select(x: torch.Tensor, seg: tuple, seg_t: torch.Tensor,
                num: int) -> torch.Tensor:
        """The (B, E, d) block inputs of (B, num, d) blocks."""
        return x if seg == tuple(range(num)) else x.index_select(1, seg_t)

    def _block_route(self, v: torch.Tensor, fwht_kernel: bool,
                     fwht_mode: str) -> bool:
        """`window_block_route` for values v through this design."""
        return window_block_route(v.device.type, fwht_kernel, fwht_mode,
                                  v.is_complex(), self.offset,
                                  max(self.Mr, self.Mc), self.w, self.tall,
                                  self._col_ptr is None)

    def ab(self, beta: torch.Tensor, fwht_kernel: bool = True,
           fwht_mode: str = "ms") -> torch.Tensor:
        """A @ beta. beta: (..., L*M) -> (..., n)."""
        xb = beta.reshape(-1, self.Lc, self.Mc)
        if self._block_route(beta, fwht_kernel, fwht_mode):
            # the column select folds into K1's load
            parts = srht_fwht_gather_blocks(
                xb.contiguous(), self.signs, self._idx32, self._col_ptr,
                self._col_blocks, validate=False) * self.scale[:, None]
        else:
            parts = self._fwd_blocks(self._select(xb, self.cols, self._cols_t,
                                                  self.Lc), fwht_kernel, fwht_mode)
        out = self._segment_sum(parts, self.rows, self._rows_t, self.Lr)
        return out.reshape(beta.shape[:-1] + (self.n,))

    def az(self, z: torch.Tensor, fwht_kernel: bool = True,
           fwht_mode: str = "ms") -> torch.Tensor:
        """A.T @ z. z: (..., n) -> (..., L*M)."""
        zb = z.reshape(-1, self.Lr, self.Mr)
        zs = self._select(zb, self.rows, self._rows_t, self.Lr)
        if self._block_route(z, fwht_kernel, fwht_mode):
            # the column sum folds into K1's store, in block order
            out = srht_scatter_fwht_sum(zs * self.scale[:, None], self._idx32,
                                        self.signs, self.w, self._col_ptr,
                                        self._col_blocks, validate=False)
        else:
            parts = self._adj_blocks(zs, fwht_kernel, fwht_mode)
            out = self._segment_sum(parts, self.cols, self._cols_t, self.Lc)
        return out.reshape(z.shape[:-1] + (self.LM,))

    # -- test utilities -----------------------------------------------------
    def dense(self) -> np.ndarray:
        """Materialize A as a dense (n, L*M) numpy array. Tests only."""
        eye = torch.eye(self.LM, dtype=torch.float32, device=self.device)
        return self.ab(eye).T.cpu().numpy()


@dataclass(eq=False)
class DftDesign:
    """Seeded subsampled-DFT design operator: A = sqrt(P/L) F_w[rows][:, cols]
    with F the unnormalised w-point DFT matrix and rows (n,) and cols (LM,)
    drawn without replacement from [0, w) without 0 and w/2, each sorted.
    Complex plain (scalar-W) codes only. Tensors rows and cols are int64 on
    one device; w, n, LM and the real scale are static."""

    rows: torch.Tensor
    cols: torch.Tensor
    w: int
    n: int
    LM: int
    scale: float

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @classmethod
    def draw_for_params(cls, params: SparcParams, awgn_var: float, seed,
                        pin: bool = False) -> HostDesign:
        """The design of `params` from `np.random.default_rng(seed)`, drawn
        on the host: one permutation of the allowed indices for the rows,
        then one for the columns (any other order is another design).
        `pin` pins the leaves."""
        if not params.is_complex:
            raise ValueError("DftDesign is the complex-code engine")
        if params.power_allocated or params.spatially_coupled:
            raise ValueError("DftDesign takes the plain (scalar-W) families only")
        n, LM = params.codeword_length(), params.L * params.M
        w = 1 << int(np.ceil(np.log2(max(n + 2, LM + 2))))
        rng = np.random.default_rng(seed)
        allowed = np.delete(np.arange(w, dtype=np.int32), [0, w // 2])
        rows = np.sort(rng.permutation(allowed)[:n])
        cols = np.sort(rng.permutation(allowed)[:LM])
        return HostDesign.of(cls, {"rows": rows.astype(np.int64),
                                   "cols": cols.astype(np.int64)},
                             {"w": w, "n": n, "LM": LM,
                              "scale": float(np.sqrt(params.P / params.L))}, pin)

    @classmethod
    def from_leaves(cls, leaves: dict, static: dict) -> "DftDesign":
        """The design of `draw_for_params`' leaves, once on their device."""
        return cls(**leaves, **static)

    @classmethod
    def for_params(cls, params: SparcParams, awgn_var: float, seed,
                   device=None) -> "DftDesign":
        """`draw_for_params`' design on `device`: the card unless `device`
        says otherwise."""
        device = resolve_device(device)
        return cls.draw_for_params(params, awgn_var, seed,
                                   device.type == "cuda").upload(device)

    # fwht_kernel and fwht_mode are the SRHT products' arguments; the DFT's
    # products are torch.fft calls whatever they say
    def ab(self, beta: torch.Tensor, fwht_kernel: bool = True,
           fwht_mode: str = "ms") -> torch.Tensor:
        """A @ beta. beta: (..., LM) -> (..., n) complex64."""
        x = beta.new_zeros(beta.shape[:-1] + (self.w,), dtype=torch.complex64)
        x[..., self.cols] = beta.to(torch.complex64)
        return self.scale * torch.fft.fft(x)[..., self.rows]

    def az(self, z: torch.Tensor, fwht_kernel: bool = True,
           fwht_mode: str = "ms") -> torch.Tensor:
        """A^H @ z = scale conj(fft(conj(y)))[cols] with y z at the rows.
        z: (..., n) -> (..., LM) complex64."""
        y = z.new_zeros(z.shape[:-1] + (self.w,), dtype=torch.complex64)
        y[..., self.rows] = z.to(torch.complex64)
        return self.scale * torch.fft.fft(y.conj()).conj()[..., self.cols]

    def dense(self) -> np.ndarray:
        """Materialize A as a dense (n, LM) numpy array. Tests only."""
        eye = torch.eye(self.LM, dtype=torch.complex64, device=self.device)
        return self.ab(eye).T.cpu().numpy()


ENGINES = {"srht": SparcDesign, "dft": DftDesign}


def design_class(engine: str):
    """The design class of `engine`: 'srht' (the default, every family) or
    'dft' (complex plain codes)."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {sorted(ENGINES)}, got {engine!r}")
    return ENGINES[engine]


@dataclass(eq=False)
class DesignStack:
    """D designs of one block each (W is 1 x 1) and of one shape, stacked
    along the block axis of `srht_apply`: one design per row of a batch.
    `ab` maps (D, L*M) to (D, n) and `az` maps (D, n) to (D, L*M) with row t
    going through design t, in one transform call. `for_trials` gathers the
    leaves into a stack for any assignment of designs to rows. Row t's
    result is that of `designs[t].ab` / `.az` on row t alone.

    idx (D, min(n, LM)) int64, signs (D, max(n, LM)) and scale (D,) float32
    are the single designs' leaves; w, n, LM and offset are theirs too.
    """

    idx: torch.Tensor
    signs: torch.Tensor
    scale: torch.Tensor
    w: int
    n: int
    LM: int
    offset: int
    _idx32: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        self._idx32 = self.idx.to(torch.int32)

    @classmethod
    def stack(cls, designs: list) -> "DesignStack":
        """The stack of `designs` (each validated when it was built)."""
        d0 = designs[0]
        for d in designs:
            if (d.E, d.Lr, d.Lc, d.w, d.n, d.LM, d.offset) != (
                    1, 1, 1, d0.w, d0.n, d0.LM, d0.offset):
                raise ValueError("a DesignStack takes one-block designs of one shape")
        return cls(torch.cat([d.idx for d in designs]),
                   torch.cat([d.signs for d in designs]),
                   torch.cat([d.scale for d in designs]),
                   d0.w, d0.n, d0.LM, d0.offset)

    @property
    def D(self) -> int:
        return self.idx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.signs.device

    def for_trials(self, didx: torch.Tensor) -> "DesignStack":
        """The stack whose entry t is this one's entry didx[t] (int64, on
        the stack's device): one design per row of a batch of len(didx)."""
        return DesignStack(self.idx[didx], self.signs[didx], self.scale[didx],
                           self.w, self.n, self.LM, self.offset)

    def _apply(self, v: torch.Tensor, in_dim: int, out_dim: int,
               idx_side_is_input: bool, fwht_kernel: bool, fwht_mode: str):
        if v.shape != (self.D, in_dim):
            raise ValueError(f"a stack of {self.D} designs takes ({self.D}, {in_dim}) "
                             f"rows, one per design, got {tuple(v.shape)}")
        out = srht_apply(v[None], self.idx, self.signs,
                         self.w, in_dim, out_dim, idx_side_is_input,
                         offset=self.offset, scale=self.scale,
                         fwht_kernel=fwht_kernel, fwht_mode=fwht_mode,
                         idx32=self._idx32)
        return out[0]

    def ab(self, beta: torch.Tensor, fwht_kernel: bool = True,
           fwht_mode: str = "ms") -> torch.Tensor:
        """Row t of (D, L*M) through design t -> (D, n)."""
        return self._apply(beta, self.LM, self.n, self.n > self.LM,
                           fwht_kernel, fwht_mode)

    def az(self, z: torch.Tensor, fwht_kernel: bool = True,
           fwht_mode: str = "ms") -> torch.Tensor:
        """Row t of (D, n) through design t's adjoint -> (D, L*M)."""
        return self._apply(z, self.n, self.LM, self.n <= self.LM,
                           fwht_kernel, fwht_mode)


def stack_designs(params: SparcParams, awgn_var: float, seed, count: int,
                  engine: str = "srht", device=None):
    """`count` independent designs of `params` by `engine`, design d seeded
    (seed, d): the Monte-Carlo seed convention of the JAX package's
    `stack_designs`. Returns the list of designs (the JAX package stacks
    their leaves for vmap; the port decodes one design at a time)."""
    cls = design_class(engine)
    return [cls.for_params(params, awgn_var, (seed, d), device)
            for d in range(count)]
