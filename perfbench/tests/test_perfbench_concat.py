"""The concatenated cell (`concat_z150.point`) on the CPU at a small size:
a sound run is correct; a run with the timed path broken underneath, or
with the plain reference's bfloat16 control in the program's place, is
not; the calibration's readings go through the cell's own check and
limits; the concatenated reference's self-checks; the readers of the
concatenated loop's spans and counters and the work the roofline counts.

The faults: half of each batch, an altered decision a trial, the Onsager
term left out, and the integrated decoder's derivative taken at the MMSE
posteriors in place of the BP-composed ones. The standard Onsager term in
place of the derivative is no fault at this cell's M = 2: the two are one
function there (`tests/test_torch_concat_counts.py`), so no check can
catch it."""

import json
import sys
from collections import Counter

import numpy as np
import pytest
import torch

import ldpc_sparc_tpu_torch.models.concat as concat_mod
from perfbench.calibrate_concat import altered_answer, control, half_batch, readings
from perfbench.drivers import concat_mc
from perfbench.metrics import (concat_launches_per_iter, design_build_idle_share,
                               device_idle_share, eta_idle_share, k1_roofline,
                               mc_draws_idle_share)
from perfbench.peaks import HBM_BYTES_PER_S
from perfbench.reference import concat as cref
from perfbench.run import BENCH, ROOT, Run, cell_metrics, load_json, make_driver, run_cell
from perfbench.trace import Trace

CELL = "concat_z150.point"
SMALL = ({"z": 24, "mults": 1, "t_max": 6},
         {"trials_per_point": 8, "designs": 4, "check_points": 2})
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 77


def run_small(seed=SEED):
    config, traffic = SMALL
    result, _ = run_cell(CELL, seed, 0.2, False, device="cpu",
                         driver_kw={"config_update": config, "traffic_update": traffic})
    return result


# ---- the run and its check ---------------------------------------------------------

def test_sound_run_is_correct():
    result = run_small()
    assert result["correct"], result["check"]
    e2e = {m["name"] for m in cell_metrics(SPEC, CELL, False)}
    # no memory peak on a CPU
    assert set(result["metrics"]) == e2e - {"device_mem_peak_gib"} and "setup_s" in e2e
    assert list(result)[-1] == "check"


def no_onsager(amp_step):
    """An AMP step that drops the Onsager term it is given."""
    def run(self, *a, **k):
        return amp_step(self, *a, **{**k, "onsager": "none"})
    return run


def mmse_derivative(derivative):
    """The integrated decoder's derivative taken at the MMSE posteriors
    (alpha) in place of the BP-composed ones (gamma)."""
    def run(alpha, vk, vk0, beta_probs, *a):
        return derivative(alpha, vk, vk0, alpha, *a)
    return run


@pytest.mark.parametrize("fault", ["half_batch", "altered_answer", "no_onsager",
                                   "mmse_derivative", "bf16_reference"])
def test_broken_run_is_not_correct(fault, monkeypatch):
    codec = concat_mod.ConcatCodec
    if fault == "half_batch":
        monkeypatch.setattr(codec, "decode_soft", half_batch(codec.decode_soft))
    elif fault == "altered_answer":
        monkeypatch.setattr(codec, "decode_soft", altered_answer(codec.decode_soft))
    elif fault == "no_onsager":
        monkeypatch.setattr(codec, "_amp_step", no_onsager(codec._amp_step))
    elif fault == "mmse_derivative":
        monkeypatch.setattr(concat_mod, "integrated_onsager_derivative",
                            mmse_derivative(concat_mod.integrated_onsager_derivative))
    else:                  # the reference one precision down, in the program's place
        monkeypatch.setattr(concat_mc.Driver, "point",
                            lambda self, i: self.reference(i, precision="bfloat16"))
    result = run_small()
    assert not result["correct"], result["check"]


def small_driver(seed, **kw):
    config, traffic = SMALL
    _, _, drv = make_driver(CELL, seed, "cpu", config, traffic, **kw)
    return drv


@pytest.mark.parametrize("side", [None, "c", "d", "e"])
def test_calibration_holds_each_side_to_the_cells_limits(side):
    """The program passes the limits through `Driver.check`; the bfloat16
    reference (c), half a batch (d) and an altered decision (e) do not."""
    seed, points = 2**31 + 5, 2
    ref_drv = small_driver(seed)
    wants = [ref_drv.reference(i) for i in range(points)]
    drv = small_driver(seed)
    if side is not None:
        with control(side, drv):
            got = readings(drv, seed, points, wants)
        assert "point" not in drv.__dict__
    else:
        got = readings(drv, seed, points, wants)
    assert got["points"] == [0, 1]
    assert got["correct"] == (side is None), got
    assert got["over"] == [k for k, lim in drv.traffic["limits"].items() if got[k] > lim]
    if side == "c":
        assert got["tau_gap"] > 100 * drv.traffic["limits"]["tau_gap"]


# ---- the concatenated reference ----------------------------------------------------

CONCAT = dict(standard="802.16", rate="1/2", z=24, mults=1, logM=1, P=19.44, R=1.0,
              t_max=6, bp_inner_iters=6, bp_final_iters=200, decoder="integrated")


def test_reference_is_a_function_of_the_seed_and_the_trial():
    """Trial t's outputs do not move with the trials beside it: a point of
    6 trials in 3 designs holds the first 3 of 6 trials in 3 designs."""
    six = cref.point_outputs(CONCAT, 19.44 / 3.2, (3, 1), 6, 3, "cpu")
    three = cref.point_outputs(CONCAT, 19.44 / 3.2, (3, 1), 3, 3, "cpu")
    for k in ("errs", "bp_iters", "tau_sqr"):
        np.testing.assert_array_equal(six[k][:3], three[k])
    assert six["tau_sqr"].shape == (6, 6) and six["frames"] == 6


def test_reference_decodes_a_clean_channel():
    """Far above the threshold every trial decodes without error, the
    first BP calls stop early and tau^2 falls to the noise variance."""
    out = cref.point_outputs({**CONCAT, "t_max": 10}, 19.44 / 30.0, (4, 0), 4, 2, "cpu")
    assert (out["errs"] == 0).all() and (out["bp_iters"] < 9 * 6).all()
    np.testing.assert_allclose(out["tau_sqr"][:, -1], 19.44 / 30.0, rtol=0.2)


def test_reference_codewords_satisfy_the_checks():
    code = cref.Code.build(150)
    info = np.random.default_rng(0).integers(0, 2, (3, code.K))
    x = code.encode(info)
    llr = torch.as_tensor(10.0 * (1.0 - 2.0 * x), dtype=torch.float32)
    app, iters = cref.bp_decode(llr, code, 20)
    assert iters.tolist() == [0, 0, 0] and ((app < 0).numpy() == x).all()


@pytest.mark.parametrize("M", [2, 4, 8])
def test_bridges_are_sums_and_products_over_bits(M):
    logM = M.bit_length() - 1
    alpha = torch.softmax(torch.randn(3, 5, M, dtype=torch.float64), -1).reshape(3, -1)
    p0 = cref.sections_to_bits(alpha, M).reshape(3, 5, logM)
    q = np.arange(M)
    for k in range(logM):
        zero = torch.as_tensor((q >> (logM - 1 - k)) & 1 == 0)
        torch.testing.assert_close(p0[..., k], alpha.reshape(3, 5, M)[..., zero].sum(-1))
    back = cref.bits_to_sections(p0.reshape(3, -1), M).reshape(3, 5, M)
    torch.testing.assert_close(back.sum(-1), torch.ones(3, 5, dtype=torch.float64))


@pytest.mark.parametrize("product", ["ab", "az"])
def test_bf16_design_is_the_design_to_bfloat16_precision(product):
    """The control's design has the float32 design's selection, signs and
    scale; its products agree to bfloat16's rounding, not to float32's."""
    W, L, M, n = np.array([[19.44]]), 96, 2, 96
    exact = cref.Design.build(W, L, M, n, (7, 0), "cpu")
    low = cref.Bf16Design.build(W, L, M, n, (7, 0), "cpu")
    torch.testing.assert_close(low.signs, exact.signs, rtol=0, atol=0)
    v = torch.randn(4, L * M if product == "ab" else n, generator=torch.Generator().manual_seed(1))
    a, b = getattr(exact, product)(v), getattr(low, product)(v)
    rel = float((a - b).norm() / a.norm())
    assert a.dtype == b.dtype == torch.float32 and 1e-5 < rel < 2e-2


def test_an_unknown_precision_is_refused():
    with pytest.raises(ValueError, match="precision"):
        cref.point_outputs(CONCAT, 1.0, (0, 0), 2, 1, "cpu", precision="float16")


# ---- the readers -------------------------------------------------------------------

CONCAT_COUNTS = Counter({"concat.decodes": 4, "concat.iters": 100})
TRACING = "ldpc_sparc_tpu_torch.utils.tracing"


def traced_run(gaps, window=2.0, busy=1.0):
    return Run(trace=Trace(window_s=window, points=1, busy_s=busy, launches=10,
                           gaps=[list(g) for g in gaps]))


def test_readers_read_the_loop_spans_and_counters(monkeypatch):
    from ldpc_sparc_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "_COUNTS", CONCAT_COUNTS)
    run = traced_run([("concat.eta", 0.6), ("concat.amp", 0.1), ("aten::mm", 0.05),
                      ("mc.designs", 0.2), ("mc.bits", 0.06), ("mc.noise", 0.04),
                      ("host in concat_mc_counts, outside torch ops", 0.1)], busy=1.2)
    run.trace.points, run.trace.launches = 3, 4500
    assert eta_idle_share.read(run) == pytest.approx(30.0)
    assert design_build_idle_share.read(run) == pytest.approx(10.0)
    assert mc_draws_idle_share.read(run) == pytest.approx(5.0)
    assert device_idle_share.read(run) == pytest.approx(40.0)
    assert concat_launches_per_iter.read(run) == pytest.approx(4500 / (3 * 25))


@pytest.mark.parametrize("reader", [eta_idle_share, concat_launches_per_iter])
def test_readers_without_a_concatenated_decode_return_none(reader, monkeypatch):
    from ldpc_sparc_tpu_torch.utils import tracing
    run = traced_run([("concat.eta", 0.6)])
    monkeypatch.setattr(tracing, "_COUNTS", Counter({"amp.row_iters": 9}))
    assert reader.read(run) is None                 # a SPARC run: nothing to read
    monkeypatch.setattr(tracing, "_COUNTS", CONCAT_COUNTS)
    assert reader.read(Run()) is None               # no trace
    monkeypatch.setitem(sys.modules, TRACING, None)  # a program without spans
    assert reader.read(run) is None


def test_k1_product_at_the_cells_shape():
    """One block of 2^15, the offset-1 window above L M = 28,800, 160 rows:
    bytes-bound, beta and y read and written once."""
    traffic = load_json(BENCH / "workloads" / f"{CELL}.json")
    config = load_json(BENCH / "configs" / f"{traffic['config']}.json")
    work = concat_mc.Driver(config, traffic, 0, "cpu").work()
    assert (work["rows"], work["E"], work["w"], work["LM"], work["n"]) == \
        (160, 1, 2**15, 28800, 14400)
    nbytes = 4 * 160 * (28800 + 14400) + 2**15 / 8
    assert k1_roofline.product_least_s(work) == pytest.approx(nbytes / HBM_BYTES_PER_S)
    t = Trace(window_s=1.0, points=1, busy_s=0.5, launches=60,
              kernels={"void fwht_onchip_kernel<15>(float const*)": [51, 51e-3]})
    share = k1_roofline.read(Run(work=work, trace=t))
    assert share == pytest.approx(100 * nbytes / HBM_BYTES_PER_S / 1e-3)
