"""The plain reference against the program's `sparc_mc_counts` at small
sizes on the CPU: the same designs, draws and decisions give the same
counters, exactly."""

import numpy as np
import pytest
import torch

from perfbench.reference import sparc as ref

from ldpc_sparc_tpu_torch import DecodeParams, SparcParams
from ldpc_sparc_tpu_torch.parallel.montecarlo import sparc_mc_counts

PLAIN = {"P": 15.0, "R": 1.0, "L": 64, "M": 64, "t_max": 14}
SC = {"P": 15.0, "R": 1.5, "L": 64, "M": 64, "spatially_coupled": True, "omega": 2,
      "Lambda": 8, "t_max": 18}
KEYS = ("bit_errs", "bits", "sec_errs", "sections", "frame_errs", "frames", "iters")


def program_counts(cfg, awgn_var, point_seed, n_trials, n_designs):
    params = SparcParams(**{k: v for k, v in cfg.items() if k != "t_max"})
    return sparc_mc_counts(params, DecodeParams(t_max=cfg["t_max"]), awgn_var,
                           point_seed, n_trials, n_designs, device="cpu",
                           fused_denoiser=True)


@pytest.mark.parametrize("cfg,snr,seed", [
    (PLAIN, 6.0, 0), (PLAIN, 3.0, 2**31 + 11), (PLAIN, 4.2, 7),
    (SC, 15.0, 5), (SC, 6.0, 2**31 + 3)])
def test_reference_counts_equal_program(cfg, snr, seed):
    awgn_var = cfg["P"] / snr
    got = program_counts(cfg, awgn_var, (seed, 3), 12, 4)
    want = ref.point_counts(cfg, awgn_var, (seed, 3), 12, 4, torch.device("cpu"))
    assert {k: got[k] for k in KEYS} == {k: want[k] for k in KEYS}
    assert want["trial_iters"].sum() == want["iters"]


def test_counters_are_exercised():
    """Below the threshold every counter moves, and still matches."""
    cfg, awgn_var = PLAIN, PLAIN["P"] / 2.0
    got = program_counts(cfg, awgn_var, (1, 0), 8, 2)
    want = ref.point_counts(cfg, awgn_var, (1, 0), 8, 2, torch.device("cpu"))
    assert want["bit_errs"] > 0 and want["sec_errs"] > 0 and want["frame_errs"] > 0
    assert {k: got[k] for k in KEYS} == {k: want[k] for k in KEYS}


@pytest.mark.parametrize("log_w", [0, 1, 5, 6, 11, 12])
def test_fwht_is_the_sylvester_hadamard(log_w):
    w = 1 << log_w
    i = np.arange(w)
    H = np.where(np.vectorize(lambda v: bin(v).count("1") % 2)(i[:, None] & i[None, :]),
                 -1.0, 1.0)
    x = torch.randn(3, w, dtype=torch.float64)
    np.testing.assert_allclose(ref.fwht(x).numpy(), x.numpy() @ H, atol=1e-9)


def test_code_shapes_of_the_cells():
    W, n, bits = ref.code_shape({"P": 15.0, "R": 1.0, "L": 1024, "M": 512})
    assert W.shape == (1, 1) and n == 9216 and bits == 9216
    W, n, bits = ref.code_shape({"P": 15.0, "R": 1.5, "L": 2048, "M": 512,
                                 "spatially_coupled": True, "omega": 6, "Lambda": 32})
    assert W.shape == (37, 32) and np.count_nonzero(W) == 192 and n == 12284


@pytest.mark.parametrize("target", [[0], [0, 1, 2], [0, 0, 1, 0, 2, 1], [3, 1, 3, 3, 0]])
@pytest.mark.parametrize("stored", ["block order", "reversed"])
def test_segment_sum_adds_each_block_once_in_block_order(target, stored):
    target = np.asarray(target)
    rank = ref._rank(target)
    place = np.arange(len(target))
    if stored == "reversed":
        place = place[::-1].copy()
    order = np.argsort(place)
    t = lambda a: a if isinstance(a, slice) else torch.as_tensor(a, dtype=torch.int64)
    passes = tuple((t(sel), t(tg)) for sel, tg in ref._passes(rank, place, target))
    covered = np.concatenate([np.arange(len(target))[sel] for sel, _ in passes])
    assert sorted(covered.tolist()) == list(range(len(target)))
    n_out = int(target.max()) + 1
    assert all(len(set(np.arange(n_out)[tg].tolist())) == len(np.arange(n_out)[tg])
               for _, tg in passes)
    parts = torch.randn(2, len(target), 5, dtype=torch.float64)
    got = ref._segment_sum(parts[:, torch.as_tensor(order)], passes, n_out)
    want = parts.new_zeros(got.shape).index_add_(1, t(target), parts)
    torch.testing.assert_close(got, want)


def test_sc_design_sums_in_slices_on_its_wide_side():
    W, n, _ = ref.code_shape({"P": 15.0, "R": 1.5, "L": 64, "M": 64,
                              "spatially_coupled": True, "omega": 2, "Lambda": 8})
    A = ref.Design.build(W, 64, 64, n, (1, 0), torch.device("cpu"))
    assert A.Mc >= A.Mr
    assert all(isinstance(sel, slice) and isinstance(tg, slice) for sel, tg in A.az_passes)
    assert len(A.az_passes) == 2 and len(A.ab_passes) == 2
