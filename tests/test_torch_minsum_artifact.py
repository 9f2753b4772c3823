"""The port held to `docs/artifacts/minsum_campaign.json`, the min-sum
waterfalls of three codes (802.16 r=1/2, 802.11n r=1/2, 802.16 r=3/4, all
z=27 A; batch 512, `minsum` with corr_factor 0.7, <= 200 iterations, >= 100
block errors a point).

The held statistic is the block error rate: blocks are independent draws,
so a point is held within the two-sample bound Z_999 sqrt(p (1 - p) (1/n1 +
1/n2)) on nblkerr / nblocks (`artifacts.compare_minsum_point`). On the CPU
each code's cliff point, one batch of 512 codewords, runs through the
port's plain BP; the card runs the points nearest BER 1e-4 and the three
22-point walks, whose interpolated SNR at BER 1e-4 must lie within 0.15 dB
of the artifact's (chip_smoke.py, tests/test_torch_kernels.py).
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from ldpc_sparc_tpu_torch import artifacts

ROOT = Path(__file__).resolve().parent.parent
# (standard, rate): (cliff SNR dB, blkerr, blocks), (point nearest BER 1e-4)
HELD = {("802.16", "1/2"): ((1.5917, 146, 512), (2.8895, 101, 10240)),
        ("802.11n", "1/2"): ((1.5917, 118, 512), (2.5384, 100, 12800)),
        ("802.16", "3/4"): ((4.1979, 174, 512), (5.2109, 100, 33792))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _benchmark_snr_at_ber():
    """benchmarks/minsum_campaign.py's interpolation, which wrote the
    artifact's `snr_at_1e-4_minsum` (the module imports JAX only in main)."""
    spec = importlib.util.spec_from_file_location(
        "minsum_campaign_bench", ROOT / "benchmarks" / "minsum_campaign.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.snr_at_ber


@pytest.mark.parametrize("code", artifacts.MINSUM_CODES)
def test_minsum_config_and_held_points(code):
    cfg = artifacts.minsum_config(*code)
    assert (cfg["standard"], cfg["rate"], cfg["z"], cfg["ptype"]) == (*code, 27, "A")
    pr = cfg["protocol"]
    assert (pr["batch"], pr["dectype"], pr["corr_factor"], pr["max_iters"],
            pr["min_errors"], pr["max_blocks"]) == (512, "minsum", 0.7, 200, 100, 400000)
    pts = cfg["minsum_points"]
    assert len(pts) == 22 and all(p["nbits"] == p["nblocks"] * pts[0]["nbits"] // 512
                                  for p in pts)
    for got, (snr, blkerr, blocks) in zip(artifacts.minsum_held_points(cfg), HELD[code]):
        assert round(got["snr"], 4) == snr
        assert (got["nblkerr"], got["nblocks"]) == (blkerr, blocks)


@pytest.mark.parametrize("code", artifacts.MINSUM_CODES)
def test_snr_at_ber_is_the_artifacts(code):
    """The port's copy of the interpolation gives the artifact's number, and
    the benchmark's function's on the waterfall and on tails with zeros."""
    cfg = artifacts.minsum_config(*code)
    pts = cfg["minsum_points"]
    assert artifacts.snr_at_ber(pts) == cfg["snr_at_1e-4_minsum"]
    bench = _benchmark_snr_at_ber()
    zeros = [dict(p, ber=0.0, nbiterr=0) if i > 15 else p for i, p in enumerate(pts)]
    for case in (pts, zeros, pts[:10], list(reversed(pts))):
        assert artifacts.snr_at_ber(case) == bench(case)
    assert artifacts.snr_at_ber(pts[:10]) is None


def _record(cfg, point, nblocks, nblkerr, ber=None):
    K = point["nbits"] // point["nblocks"]
    ber = point["ber"] if ber is None else ber
    return (cfg["standard"], cfg["rate"], cfg["z"], cfg["ptype"], point["snr"], nblocks,
            nblkerr, nblocks * K, round(ber * nblocks * K), 0)


def test_compare_minsum_point_holds_the_block_error_rate():
    cfg = artifacts.minsum_config("802.16", "1/2")
    cliff, near = artifacts.minsum_held_points(cfg)
    own = artifacts.compare_minsum_point(cfg, _record(cfg, cliff, 512, cliff["nblkerr"]))
    assert own["ok"] and own["port"] == own["artifact"] == 146 / 512
    assert own["bound"] == pytest.approx(
        artifacts.two_sample_bound(146 / 512, 512, 146 / 512, 512))
    # the bound at the cliff: about 0.09 in BLER; 80 or 210 blocks of 512 fail
    assert not artifacts.compare_minsum_point(cfg, _record(cfg, cliff, 512, 80))["ok"]
    assert not artifacts.compare_minsum_point(cfg, _record(cfg, cliff, 512, 210))["ok"]
    # the same BER with twice the block errors fails: BLER is what is held,
    # where the campaign's 0.02 BER floor would pass anything
    bad = _record(cfg, near, 10240, 2 * near["nblkerr"])
    got = artifacts.compare_minsum_point(cfg, bad)
    assert not got["ok"] and got["port_ber"] == pytest.approx(near["ber"], rel=1e-3)
    assert artifacts.compare_minsum_point(cfg, _record(cfg, near, 10240, 101))["ok"]
    with pytest.raises(KeyError):
        artifacts.compare_minsum_point(cfg, _record(cfg, dict(near, snr=2.5), 512, 1))


def test_record_point_and_the_walks_hold():
    """A walk's records become the artifact's points, and its SNR at BER
    1e-4 is held within 0.15 dB: the artifact's own points pass, and the
    same waterfall shifted by 0.2 dB fails."""
    cfg = artifacts.minsum_config("802.11n", "1/2")
    recs = [_record(cfg, p, p["nblocks"], p["nblkerr"]) for p in cfg["minsum_points"]]
    pts = [artifacts.record_point(r) for r in recs]
    assert [(p["snr"], p["nblocks"], p["nblkerr"], p["nbits"]) for p in pts] == [
        (p["snr"], p["nblocks"], p["nblkerr"], p["nbits"]) for p in cfg["minsum_points"]]
    want = cfg["snr_at_1e-4_minsum"]
    assert abs(artifacts.snr_at_ber(pts) - want) < 1e-6
    shifted = [dict(p, snr=p["snr"] + 0.2) for p in pts]
    assert abs(artifacts.snr_at_ber(shifted) - want) > artifacts.MINSUM_SNR_TOL_DB


@pytest.mark.parametrize("code", artifacts.MINSUM_CODES)
def test_cliff_point_through_the_plain_bp(code):
    """Each code's cliff point, one batch of 512 codewords under the
    artifact's protocol, through the port's plain BP on the CPU: its block
    error rate within the two-sample bound of the artifact's."""
    cfg = artifacts.minsum_config(*code)
    cliff, _ = artifacts.minsum_held_points(cfg)
    rec = artifacts.run_campaign_point(cfg, cliff["snr"], seed=0, device="cpu",
                                       bp_kernel=False)
    assert rec[5] == 512 and rec[6] >= cfg["protocol"]["min_errors"]
    got = artifacts.compare_minsum_point(cfg, rec)
    assert got["ok"], got
