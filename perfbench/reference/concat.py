"""Plain reference for a concatenated LDPC-SPARC Monte Carlo point: the
LDPC code, the encode, the draws, the integrated (or naive) AMP + BP decode
and each trial's outputs, in numpy and plain PyTorch.

It follows the reference simulator (LDPC_SPARC, `sparc_sophie/sparc_new.py`)
for a fully protected message:

* encode (`sparc_ldpc_encode`, :15-51): user bits in `mults` blocks of K,
  each block LDPC-encoded by the dual-diagonal parity chain
  (`ldpc_jossy/py/ldpc.py:400-460`) of the IEEE 802.16 rate-1/2 code (its
  table applied unscaled, shifts mod z, as `ldpc.py:298,376` do), the
  coded bits spread over L sections of M (bits MSB first within a
  section) with amplitude c = sqrt(n P / L), then x = A beta0 with
  A = D / c, D the SRHT design of `reference/sparc.py` on base matrix [[P]];
* AMP step (`integrated_decoder`, :489-494): z = y - A beta + (z / n) *
  sum(eta'), s = A^T z + beta, tau^2 = |z|^2 / n; the naive decoder
  (`naively_integrated_decoder`, :257-282) takes the standard term
  (z / tau^2)(P - |beta|^2 / n) instead;
* eta (:709-735): the MMSE estimate c softmax(s c / tau^2) per section,
  alpha = estimate / c; per bit P(bit = 0), the sum of alpha over the
  sections whose bit is 0 (`beta_estimate_to_bp_probs`, :1118-1138);
  `num_its` iterations of BP on each block (`ldpc_bp`, :1162-1193); back to
  sections, the product over bits of P(bit = 0) or 1 - P(bit = 0)
  (`bp_output_to_beta_estimate`, :1260-1279), taken as the exponential of
  the sum of the logarithms; beta = c times that;
* the Onsager derivative (`differentiated_eta_calc` with `sub_term`,
  :824-883): with A_k = sum over S_k of alpha and D_k = v0 (1 - v0) at
  the clipped BP input v0,
  eta'[l, q] = c gamma[l, q] (c / tau^2) alpha[l, q]
               (sum_{k: q in S_k} (1 - v_k - A_k) / D_k + sum_k v_k A_k / D_k);
* the last step: AMP, MMSE, bits, `bp_final` iterations of hard BP, the
  first K bits of each block.

The BP is the plain sum-product over the Tanner graph (`c_ldpc.c`): each
variable sums its channel LLR first, then its edges in ascending edge id;
each check takes the forward-backward Lxor trellis of its edges (Lxor with
sign(0) = +1 and both log1p corrections); a codeword stops, and keeps its
messages and APP, at the first iteration whose checks all hold (the Lxor of
all of a check's inputs > 0), and its iteration count is the number of
iterations after which they did not yet hold.

Per point seed `ps`, trial t draws its user bits then its noise from the
generator of `reference/sparc.py`'s `trial_generator(ps, t)` and takes
design (ps, t % n_designs). The point's trials decode as one batch: each
design product takes a design's rows through that design, everything else
acts on each row alone (no row's arithmetic touches another's). The
transform is `reference/sparc.py`'s plain Walsh-Hadamard transform
(float32 matmuls, TF32 off).

`precision="bfloat16"` runs the decoder's transform on bfloat16 operands,
each radix stage rounding to bfloat16 (`Bf16Design`), the rest float32 and
the channel (draws, encode, A beta0) as before: the nearest precision below the float32 the configuration states,
the calibration's control (c), never the check's reference.

Departures from `sparc_new.py`, all from float32 (the reference runs in
float64): P(bit = 0) is clipped to [1e-7, 1 - 1e-7] before the LLRs and
before the product over bits (1 - 1e-15 rounds to 1), D_k's input to
[1e-6, 1 - 1e-6] (the reference's 1e-10 lets D round to 0). The LLR is
log(p) - log1p(-p), the posterior sigmoid(app), and the product over bits
a sum of logarithms (the reference multiplies; the two differ by rounding
alone). Nothing here imports the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .sparc import Design, fwht, trial_generator

BIG = 1e30          # a padded check input: the Lxor identity
PROB_EPS = 1e-7     # float32 clip of P(bit = 0) before LLRs and products
DERIV_EPS = 1e-6    # float32 clip of the BP input inside D_k

# IEEE 802.16e rate 1/2 (type A) base matrix, shifts for z = 96 ("." = no edge)
IEEE80216_R12 = """\
. 94 73 . . . . . 55 83 . . 7 0 . . . . . . . . . .
. 27 . . . 22 79 9 . . . 12 . 0 0 . . . . . . . . .
. . . 24 22 81 . 33 . . . 0 . . 0 0 . . . . . . . .
61 . 47 . . . . . 65 25 . . . . . 0 0 . . . . . . .
. . 39 . . . 84 . . 41 72 . . . . . 0 0 . . . . . .
. . . . 46 40 . 82 . . . 79 0 . . . . 0 0 . . . . .
. . 95 53 . . . . . 14 18 . . . . . . . 0 0 . . . .
. 11 73 . . . 2 . . 47 . . . . . . . . . 0 0 . . .
12 . . . 83 24 . 43 . . . 51 . . . . . . . . 0 0 . .
. . . . . 94 . 59 . . 70 72 . . . . . . . . . 0 0 .
. . 7 65 . . . . 39 49 . . . . . . . . . . . . 0 0
43 . . . . 66 . 41 . . . 26 7 . . . . . . . . . . 0
"""


def protograph() -> np.ndarray:
    """The (12, 24) base matrix, -1 where there is no edge."""
    return np.array([[-1 if t == "." else int(t) for t in line.split()]
                     for line in IEEE80216_R12.strip().splitlines()], dtype=np.int64)


# --------------------------------------------------------------------------
# the LDPC code
# --------------------------------------------------------------------------

@dataclass
class Code:
    """The 802.16 rate-1/2 code at expansion z: edges in row-major order of
    the base matrix, edge e joining check (row[e], c) to variable
    (col[e], (c + shift[e]) mod z)."""

    z: int
    proto: np.ndarray
    row: np.ndarray
    col: np.ndarray
    shift: np.ndarray

    @classmethod
    def build(cls, z: int) -> "Code":
        proto = protograph()
        row, col = np.nonzero(proto != -1)
        return cls(z, proto, row, col, proto[row, col] % z)

    @property
    def Mp(self) -> int:
        return self.proto.shape[0]

    @property
    def Np(self) -> int:
        return self.proto.shape[1]

    @property
    def K(self) -> int:
        return (self.Np - self.Mp) * self.z

    @property
    def N(self) -> int:
        return self.Np * self.z

    def parity(self, info: np.ndarray) -> np.ndarray:
        """The dual-diagonal parity chain (ldpc.py:400-460): info (B, K)
        {0, 1} -> parity bits (B, N - K)."""
        z, Kp, Mp, proto = self.z, self.Np - self.Mp, self.Mp, self.proto
        x = info.reshape(-1, Kp, z)
        # systematic part of each check row: p[j] = XOR_k roll(x[k], -shift)
        p = np.zeros((x.shape[0], Mp, z), np.int64)
        for j in range(Mp):
            for k in range(Kp):
                if proto[j, k] != -1:
                    p[:, j] += np.roll(x[:, k], -int(proto[j, k]), axis=-1)
        p %= 2
        # the first parity block: the offsets of column Kp cancel in pairs
        # but one, which the sum of all check rows is shifted by
        counts = np.zeros(z, dtype=int)
        for j in range(Mp):
            if proto[j, Kp] != -1:
                counts[proto[j, Kp] % z] += 1
        (odd,) = np.flatnonzero(counts % 2)
        blocks = [np.roll(p.sum(axis=1) % 2, int(odd), axis=-1)]
        # back-substitution down the dual diagonal
        for j in range(Mp - 1):
            acc = p[:, j].copy()
            for k in range(j + 1):
                if proto[j, Kp + k] != -1:
                    acc += np.roll(blocks[k], -int(proto[j, Kp + k]), axis=-1)
            blocks.append(acc % 2)
        return np.concatenate(blocks, axis=-1)

    def encode(self, info: np.ndarray) -> np.ndarray:
        """Systematic codewords (B, N): info, then parity."""
        return np.concatenate([info, self.parity(info)], axis=-1)


def _lxor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LLR of the XOR of two bits (c_ldpc.c:234-251): the signs' product
    (sign(0) = +1) times the smaller magnitude, plus the exact corrections."""
    sgn = torch.sign(a) * torch.sign(b)
    sgn = torch.where(sgn == 0.0, 1.0, sgn)
    out = sgn * torch.minimum(a.abs(), b.abs())
    out = out + torch.log1p(torch.exp(-(a + b).abs()))
    return out - torch.log1p(torch.exp(-(a - b).abs()))


def bp_decode(ch: torch.Tensor, code: Code, max_iters: int):
    """Sum-product BP of channel LLRs ch (B, N): (app (B, N), iterations
    (B,) int64). See the module docstring for the order of the sums and
    the stop rule."""
    B, z, dev = ch.shape[0], code.z, ch.device
    E = len(code.row)
    pos = torch.arange(z, device=dev)
    shift = torch.as_tensor(code.shift, device=dev)[:, None]
    var_of = ((pos[None, :] + shift) % z).expand(B, E, z)    # check slot -> variable
    chk_of = ((pos[None, :] - shift) % z).expand(B, E, z)    # variable slot -> check
    col_edges = [np.flatnonzero(code.col == j) for j in range(code.Np)]
    row_edges = [np.flatnonzero(code.row == i) for i in range(code.Mp)]
    dv, dc = max(map(len, col_edges)), max(map(len, row_edges))
    pad = lambda lists, d: torch.as_tensor(np.array(
        [np.concatenate([e, np.full(d - len(e), E)]) for e in lists]), device=dev)
    cols, rows = pad(col_edges, dv), pad(row_edges, dc)     # E: a padding edge
    slot = torch.empty(E, dtype=torch.int64, device=dev)    # each edge's place in rows
    flat = rows.reshape(-1)
    slot[flat[flat < E]] = torch.nonzero(flat < E)[:, 0]
    chb = ch.reshape(B, code.Np, z)
    c2v = ch.new_zeros(B, E, z)                    # check to variable, check order
    app = torch.zeros_like(chb)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        if bool(done.all()):
            break
        # variables: channel LLR first, then the edges in ascending id
        at_var = torch.cat([c2v.gather(2, chk_of), c2v.new_zeros(B, 1, z)], 1)
        tot = chb
        for k in range(dv):
            tot = tot + at_var[:, cols[:, k]]
        v2c = (tot[:, torch.as_tensor(code.col, device=dev)] - at_var[:, :E]).gather(2, var_of)
        # checks: the forward-backward trellis along each row's edges
        L = torch.cat([v2c, c2v.new_full((B, 1, z), BIG)], 1)[:, rows]   # (B, Mp, dc, z)
        fwd, bwd = [L[:, :, 0]], [L[:, :, dc - 1]]
        for k in range(1, dc):
            fwd.append(_lxor(fwd[-1], L[:, :, k]))
            bwd.append(_lxor(bwd[-1], L[:, :, dc - 1 - k]))
        bwd = bwd[::-1]
        ext = [bwd[1]] + [_lxor(fwd[k - 1], bwd[k + 1]) for k in range(1, dc - 1)] \
            + [fwd[dc - 2]]
        new = torch.stack(ext, 2).reshape(B, -1, z)[:, slot]
        holds = (bwd[0] > 0).reshape(B, -1).all(1)
        frozen = done[:, None, None]
        c2v = torch.where(frozen, c2v, new)
        app = torch.where(frozen, app, tot)
        iters = torch.where(done | holds, iters, iters + 1)
        done = done | holds
    return app.reshape(B, code.N), iters


# --------------------------------------------------------------------------
# the bridges and the denoiser
# --------------------------------------------------------------------------

def bit_zero_sets(M: int) -> list[np.ndarray]:
    """S_k (sparc_new.py:1140-1160): the section entries whose bit k (MSB
    first) is 0."""
    logM = M.bit_length() - 1
    q = np.arange(M)
    return [np.flatnonzero((q >> (logM - 1 - k)) & 1 == 0) for k in range(logM)]


def sections_to_bits(alpha: torch.Tensor, M: int) -> torch.Tensor:
    """(B, L M) section posteriors -> (B, L logM) P(bit = 0)."""
    sec = alpha.reshape(alpha.shape[0], -1, M)
    return torch.stack([sec[..., S].sum(-1) for S in bit_zero_sets(M)], -1) \
        .reshape(alpha.shape[0], -1)


def bits_to_sections(p0: torch.Tensor, M: int) -> torch.Tensor:
    """(B, L logM) P(bit = 0) -> (B, L M): each entry the product over
    bits of P(bit = 0) where its bit is 0, else 1 - P(bit = 0), taken as
    the exponential of the sum of their logarithms."""
    logM = M.bit_length() - 1
    p = p0.reshape(p0.shape[0], -1, logM).clamp(PROB_EPS, 1.0 - PROB_EPS)
    log_sum = p.new_zeros(p.shape[0], p.shape[1], M)
    for k, S in enumerate(bit_zero_sets(M)):
        zero = torch.zeros(M, dtype=torch.bool, device=p.device)
        zero[torch.as_tensor(S, device=p.device)] = True
        log_sum = log_sum + torch.where(zero, torch.log(p[..., k:k + 1]),
                                        torch.log1p(-p[..., k:k + 1]))
    return torch.exp(log_sum).reshape(p0.shape[0], -1)


def eta_derivative(alpha, vk, vk0, gamma, tau_sqr, M: int, c: float) -> torch.Tensor:
    """eta' of the integrated decoder, (B, L M) (see the module docstring)."""
    B = alpha.shape[0]
    a = alpha.reshape(B, -1, M)
    v = vk.reshape(B, a.shape[1], -1)
    v0 = vk0.reshape(B, a.shape[1], -1).clamp(DERIV_EPS, 1.0 - DERIV_EPS)
    D = v0 * (1.0 - v0)
    per_bit = torch.zeros_like(a)
    across = torch.zeros_like(a[..., :1])
    for k, S in enumerate(bit_zero_sets(M)):
        A_k = a[..., S].sum(-1)
        per_bit[..., S] += ((1.0 - v[..., k] - A_k) / D[..., k])[..., None]
        across = across + (v[..., k] * A_k / D[..., k])[..., None]
    main = (c / tau_sqr)[:, None, None] * a * (per_bit + across)
    return c * (gamma.reshape(a.shape) * main).reshape(B, -1)


# --------------------------------------------------------------------------
# the decoder
# --------------------------------------------------------------------------

@dataclass
class Setup:
    code: Code
    mults: int
    L: int
    M: int
    n: int
    P: float
    c: float

    @classmethod
    def of(cls, cfg: dict) -> "Setup":
        if (cfg["standard"], cfg["rate"], cfg.get("ptype", "A")) != ("802.16", "1/2", "A"):
            raise ValueError("the reference holds the 802.16 rate-1/2 code only")
        code = Code.build(int(cfg["z"]))
        mults, logM = int(cfg["mults"]), int(cfg["logM"])
        coded = code.N * mults
        L = coded // logM
        n = int(coded / float(cfg["R"]))
        P = float(cfg["P"])
        return cls(code, mults, L, 1 << logM, n, P, float(np.sqrt(n * P / L)))

    @property
    def user_bits(self) -> int:
        return self.code.K * self.mults

    def bp(self, p0: torch.Tensor, num_its: int):
        """Each block's BP on P(bit = 0) (B, mults N): (app (B, mults N),
        iterations summed over the trial's blocks (B,))."""
        B = p0.shape[0]
        p = p0.clamp(PROB_EPS, 1.0 - PROB_EPS)
        llr = (torch.log(p) - torch.log1p(-p)).reshape(B * self.mults, self.code.N)
        app, iters = bp_decode(llr, self.code, num_its)
        return app.reshape(B, -1), iters.reshape(B, self.mults).sum(-1)


class Bf16Design(Design):
    """`Design` with its transform on bfloat16 operands: the block inputs
    rounded to bfloat16, each radix stage's matmul rounding to bfloat16,
    the outputs back in float32 (selection, signs and scales as before)."""

    def _blocks(self, v: torch.Tensor, index_in: bool, out_dim: int) -> torch.Tensor:
        B, E, in_dim = v.shape
        X = v.new_zeros(B, E, self.w)
        if index_in:
            X.scatter_(2, self.idx.expand(B, E, -1), v * self.scale[:, None])
            Y = fwht(X.to(torch.bfloat16)).float()
            return Y[..., self.offset:self.offset + out_dim] * self.signs
        X[..., self.offset:self.offset + in_dim] = v * self.signs
        Y = fwht(X.to(torch.bfloat16)).float()
        return Y.gather(2, self.idx.expand(B, E, -1)) * self.scale[:, None]


DESIGNS = {"float32": Design, "bfloat16": Bf16Design}


class PointDesigns:
    """The point's designs, trial t's the design (ps, t % n_designs): each
    product takes each design's rows through that design alone."""

    def __init__(self, s: Setup, point_seed, n_trials: int, n_designs: int, device,
                 precision: str = "float32"):
        self.groups = [(DESIGNS[precision].build(np.array([[s.P]]), s.L, s.M, s.n,
                                                 (point_seed, d), device),
                        torch.arange(d, n_trials, n_designs, device=device))
                       for d in range(min(n_designs, n_trials))]
        self.shape = (n_trials, s.n), (n_trials, s.L * s.M)

    def ab(self, v: torch.Tensor) -> torch.Tensor:
        out = v.new_empty(self.shape[0])
        for A, rows in self.groups:
            out[rows] = A.ab(v[rows])
        return out

    def az(self, v: torch.Tensor) -> torch.Tensor:
        out = v.new_empty(self.shape[1])
        for A, rows in self.groups:
            out[rows] = A.az(v[rows])
        return out


def decode(y: torch.Tensor, A: PointDesigns, s: Setup, t_max: int, bp_inner: int,
           bp_final: int, decoder: str):
    """Decode y (B, n): (user-bit decisions (B, K mults), tau^2 (B, t_max),
    BP iterations (B,))."""
    if decoder not in ("integrated", "naive"):
        raise ValueError(f"the reference decodes 'integrated' and 'naive', not {decoder!r}")
    B, M, n, c = y.shape[0], s.M, s.n, s.c
    beta = y.new_zeros(B, s.L * M)
    z = torch.zeros_like(y)
    tau_sqr, deta_sum = y.new_ones(B), y.new_zeros(B)
    taus, iters = [], torch.zeros(B, dtype=torch.int64, device=y.device)
    for t in range(t_max):
        if decoder == "integrated":
            onsager = (z / n) * deta_sum[:, None]
        else:
            onsager = (z / tau_sqr[:, None]) * (s.P - (beta ** 2).sum(-1, keepdim=True) / n)
        z = y - A.ab(beta / c) + onsager
        r = A.az(z) / c + beta
        tau_sqr = (z ** 2).sum(-1) / n
        taus.append(tau_sqr)
        logits = (r * (c / tau_sqr)[:, None]).reshape(B, s.L, M)
        alpha = (c * torch.softmax(logits, -1)).reshape(B, -1) / c
        vk0 = sections_to_bits(alpha, M)
        if t == t_max - 1:
            app, it = s.bp(vk0, bp_final)
            bits = (app.reshape(B, s.mults, s.code.N)[..., :s.code.K] < 0)
            return bits.reshape(B, -1).to(torch.int64), torch.stack(taus, 1), iters + it
        app, it = s.bp(vk0, bp_inner)
        iters = iters + it
        vk = torch.sigmoid(app)
        gamma = bits_to_sections(vk, M)
        beta = c * gamma
        if decoder == "integrated":
            deta_sum = eta_derivative(alpha, vk, vk0, gamma, tau_sqr, M, c).sum(-1)


# --------------------------------------------------------------------------
# one Monte Carlo point
# --------------------------------------------------------------------------

def point_outputs(cfg: dict, awgn_var: float, point_seed, n_trials: int,
                  n_designs: int, device, precision: str = "float32") -> dict:
    """Each trial's outputs, numpy in trial order: `errs` (user-bit
    errors), `bp_iters` (BP iterations summed over the decode's calls and
    the trial's blocks), `tau_sqr` (n_trials, t_max); and `frames`.
    `precision` is the decoder's transform's ("float32" or "bfloat16")."""
    if precision not in DESIGNS:
        raise ValueError(f"precision must be one of {sorted(DESIGNS)}, got {precision!r}")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _point_outputs(cfg, awgn_var, point_seed, n_trials, n_designs,
                              torch.device(device), precision)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@torch.no_grad()
def _point_outputs(cfg, awgn_var, point_seed, n_trials, n_designs, device, precision):
    s = Setup.of(cfg)
    A = PointDesigns(s, point_seed, n_trials, n_designs, device)
    gens = [trial_generator(point_seed, t, device) for t in range(n_trials)]
    user = torch.stack([torch.randint(0, 2, (s.user_bits,), generator=g, device=device)
                        for g in gens]).to(torch.int64)
    coded = s.code.encode(user.reshape(-1, s.code.K).cpu().numpy())
    logM = s.M.bit_length() - 1
    weights = 1 << torch.arange(logM - 1, -1, -1, device=device)
    sent = (torch.as_tensor(coded, device=device).reshape(n_trials, s.L, logM)
            * weights).sum(-1)
    beta0 = torch.zeros(n_trials, s.L, s.M, device=device)
    beta0.scatter_(2, sent[..., None], s.c)
    x = A.ab(beta0.reshape(n_trials, -1) / s.c)
    y = torch.stack([xi + torch.randn(xi.shape, generator=g, device=device)
                     * float(np.sqrt(awgn_var)) for xi, g in zip(x, gens)])
    if precision != "float32":        # the channel stays the configuration's
        A = PointDesigns(s, point_seed, n_trials, n_designs, device, precision)
    got, tau, it = decode(y, A, s, int(cfg["t_max"]), int(cfg["bp_inner_iters"]),
                          int(cfg["bp_final_iters"]), cfg["decoder"])
    return {"frames": n_trials, "errs": (got != user).sum(-1).cpu().numpy(),
            "bp_iters": it.cpu().numpy(), "tau_sqr": tau.cpu().numpy()}
