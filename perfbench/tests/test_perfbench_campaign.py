"""The campaign cell (`ldpc_80211n_z81.campaign`) on the CPU at a small
size: a sound run is correct; the calibration's five controls, through the
cell's own check and limits, are not; the readers of the campaign's
counters (`k4_roofline`, `campaign_launches_per_batch`) on traces made by
hand; K4's operation count against the one `PERF.md` gives."""

import json
import sys
from collections import Counter

import pytest

from perfbench import calibrate_concat
from perfbench.calibrate_campaign import CONTROLS, control
from perfbench.drivers import ldpc_campaign
from perfbench.metrics import campaign_launches_per_batch, device_idle_share, k4_roofline
from perfbench.peaks import FLOAT32_OPS_PER_S
from perfbench.run import BENCH, ROOT, Run, cell_metrics, load_json, make_driver, run_cell
from perfbench.trace import Trace

CELL = "ldpc_80211n_z81.campaign"
# 3 batches of 16 a point at 1.2 dB, at most 30 iterations: some codewords
# run to the cap, so control (b) has something to cut
SMALL = ({"max_iters": 30},
         {"batch": 16, "blocks_per_point": 48, "check_points": 2, "snr_db": 1.2})
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 77


def test_sound_run_is_correct():
    config, traffic = SMALL
    result, checks = run_cell(CELL, SEED, 0.2, False, device="cpu",
                              driver_kw={"config_update": config,
                                         "traffic_update": traffic})
    assert result["correct"], result["check"]
    assert [c[0] for c in checks] == ["iter_gap", "blkerr_gap", "biterr_gap"]
    assert all(v == 0.0 for _, v, _ in checks)          # the same arithmetic on a CPU
    assert result["failed"] == 0 and result["attempted"] == 48 * result["points"]
    e2e = {m["name"] for m in cell_metrics(SPEC, CELL, False)}
    assert set(result["metrics"]) == e2e - {"device_mem_peak_gib"} and "setup_s" in e2e


@pytest.mark.parametrize("side", [None, "a", "b", "c", "d", "e"])
def test_calibration_holds_each_side_to_the_cells_limits(side):
    """The program passes the cell's limits through `Driver.check`; each
    control fails at least one."""
    config, traffic = SMALL
    seed, points = 2**31 + 5, 2
    kw = dict(CONTROLS.get(side, {}))
    if side == "b":                    # one iteration under the configuration's cap
        kw["max_iters"] = config["max_iters"] - 1
    ref_drv = make_driver(CELL, seed, "cpu", config, traffic)[2]
    wants = [ref_drv.reference(i) for i in range(points)]
    drv = make_driver(CELL, seed, "cpu", config, traffic, **kw)[2]
    if side in ("c", "d", "e"):
        with control(side, drv):
            got = calibrate_concat.readings(drv, seed, points, wants)
        assert "point" not in drv.__dict__
    else:
        got = calibrate_concat.readings(drv, seed, points, wants)
    assert got["points"] == [0, 1]
    assert got["correct"] == (side is None), got
    if side is None:
        assert got["errs"] == got["ref_errs"]


def test_controls_leave_the_program_as_it_was():
    from ldpc_sparc_tpu_torch.parallel import montecarlo
    real = montecarlo._batch_counts, montecarlo.bp_decode
    drv = make_driver(CELL, 0, "cpu", *SMALL)[2]
    for side in "de":
        with pytest.raises(RuntimeError):
            with control(side, drv):
                assert (montecarlo._batch_counts, montecarlo.bp_decode) != real
                raise RuntimeError
        assert (montecarlo._batch_counts, montecarlo.bp_decode) == real


# ---- the work and the readers --------------------------------------------------------

def cell_work():
    traffic = load_json(BENCH / "workloads" / f"{CELL}.json")
    config = load_json(BENCH / "configs" / f"{traffic['config']}.json")
    return ldpc_campaign.Driver(config, traffic, 0, "cpu").work()


def test_k4_count_at_the_cells_shape():
    """Ten checks of degree 7 and two of 8 a protograph row set: 198 Lxors
    of 14 operations, and 2 adds on each of 86 edges, z = 81 times."""
    work = cell_work()
    assert (work["z"], work["edges"]) == (81, 6966)
    assert k4_roofline.codeword_iter_ops(work) == 81 * (198 * 14 + 2 * 86) == 238_464


def test_k4_count_is_perfs_at_z27():
    """PERF.md's K4 row: 3,225 codeword phases of 802.11n r=1/2 z=27 (four
    checks of degree 8, eight of 7) are 17,763,300 Lxors and 264,011,400
    operations."""
    work = {"z": 27, "check_degrees": [7, 8, 7, 7, 7, 8, 7, 7, 8, 7, 8, 7], "edges": 88 * 27}
    assert k4_roofline.codeword_iter_ops(work) * 3225 == 264_011_400
    assert sum(3 * d - 5 for d in work["check_degrees"]) * 27 * 3225 == 17_763_300


COUNTS = Counter({"campaign.points": 10, "campaign.batches": 2010,
                  "campaign.codeword_iters": 10 * 1_750_000})
TRACING = "ldpc_sparc_tpu_torch.utils.tracing"
K4 = "void (anonymous namespace)::bp_decode_kernel<false, 1024, 1>(float const*)"


def traced_run(work, points=4, launches=12_000, kernels=None):
    t = Trace(window_s=2.0, points=points, busy_s=1.5, launches=launches,
              kernels=kernels if kernels is not None else
              {K4: [804, 0.5], "void at::native::elementwise_kernel<128, 2>()": [9000, 0.2]})
    return Run(work=work, trace=t)


def test_readers_read_the_campaigns_counters(monkeypatch):
    from ldpc_sparc_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "_COUNTS", COUNTS)
    work = cell_work()
    run = traced_run(work)
    least = 4 * 1_750_000 * 238_464 / FLOAT32_OPS_PER_S
    assert k4_roofline.read(run) == pytest.approx(100 * least / 0.5)
    assert campaign_launches_per_batch.read(run) == pytest.approx(12_000 / (4 * 201))
    assert device_idle_share.read(run) == pytest.approx(25.0)


@pytest.mark.parametrize("reader", [k4_roofline, campaign_launches_per_batch])
def test_readers_without_a_campaign_return_none(reader, monkeypatch):
    from ldpc_sparc_tpu_torch.utils import tracing
    work = cell_work()
    monkeypatch.setattr(tracing, "_COUNTS", Counter({"concat.decodes": 3}))
    assert reader.read(traced_run(work)) is None     # a program without the counters
    monkeypatch.setattr(tracing, "_COUNTS", COUNTS)
    assert reader.read(Run(work=work)) is None       # no trace
    monkeypatch.setitem(sys.modules, TRACING, None)  # a program without spans
    assert reader.read(traced_run(work)) is None


def test_k4_roofline_sees_k4_alone(monkeypatch):
    from ldpc_sparc_tpu_torch.utils import tracing
    monkeypatch.setattr(tracing, "_COUNTS", COUNTS)
    other = {"void lxor_chain_kernel(float*, int, bool)": [1, 1.0]}
    assert k4_roofline.read(traced_run(cell_work(), kernels=other)) is None


def test_the_cell_in_the_benchmark():
    w = next(w for w in SPEC["workloads"] if w["name"] == CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("ldpc_80211n_z81", "campaign", 1)
    layer = {m["name"] for m in cell_metrics(SPEC, CELL, True)}
    assert layer == {"k4_roofline", "campaign_launches_per_batch",
                     "device_idle_share.campaign"}
    traffic = load_json(BENCH / "workloads" / f"{CELL}.json")
    assert traffic["blocks_per_point"] % traffic["batch"] == 0
    assert ldpc_campaign.ENTRY == "ldpc_waterfall_campaign"
