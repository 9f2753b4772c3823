"""The port's reader of the JAX package's committed artifacts
(ldpc_sparc_tpu_torch/artifacts.py): the configurations and rows it reads,
its bounds, and its runners at small sizes on the CPU. The card runs them
at full size (tests/test_torch_kernels.py, chip_smoke.py phases 15-16).
"""

import math

import numpy as np
import pytest
import torch

from ldpc_sparc_tpu_torch import artifacts
from ldpc_sparc_tpu_torch.config import SparcParams

SWEEPS = ["flagship_sweep.json", "pa_sweep.json", "sc_sweep.json",
          "modulated_sweep.json", "oracle_parity_mod.json", "oracle_parity_mod_dft.json"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_config_reads_every_file(name):
    params, t_max, rows = artifacts.sweep_config(name)
    doc = artifacts.load(name)
    cfg = doc["config"]
    assert isinstance(params, SparcParams) and t_max == cfg["t_max"]
    assert (params.P, params.R, params.L, params.M) == (cfg["P"], cfg["R"], cfg["L"], cfg["M"])
    assert params.modulated == cfg.get("modulated", False)
    assert params.spatially_coupled == cfg.get("spatially_coupled", False)
    assert params.power_allocated == cfg.get("power_allocated", False)
    assert rows and all(r["frames"] > 0 for r in rows)
    for r in rows:
        assert math.isclose(r["awgn_var"], params.P / r["snr"], rel_tol=1e-9)
        assert {"fer", "ser", "ber"} <= set(r)
    if params.modulated and "rows" in doc:
        assert all({"ler", "ver"} <= set(r) for r in rows)


def test_two_sample_bound():
    assert artifacts.two_sample_bound(0.5, 256, 0.5, 256) == pytest.approx(
        3.29 * math.sqrt(0.25 * 2 / 256))
    assert artifacts.two_sample_bound(0.2, 100, 0.4, 300) == pytest.approx(
        artifacts.two_sample_bound(0.4, 300, 0.2, 100))
    assert artifacts.two_sample_bound(0.0, 128, 0.0, 128) == 0.0


def test_compare_sweep_holds_a_row_to_itself_and_flags_a_shift():
    _, _, rows = artifacts.sweep_config("modulated_sweep.json")
    own = artifacts.compare_sweep("modulated_sweep.json", rows,
                                  ("fer", "ser", "ler", "ver"))
    assert len(own) == 4 * len(rows) and all(c["ok"] for c in own)
    shifted = [dict(rows[1], ser=rows[1]["ser"] + 0.3)]
    assert [c["ok"] for c in artifacts.compare_sweep("modulated_sweep.json", shifted)] \
        == [True, False]
    with pytest.raises(KeyError):
        artifacts.compare_sweep("modulated_sweep.json", [dict(rows[0], snr=6.1)])


def test_compare_campaign_point():
    cfg = artifacts.campaign_config(artifacts.CAMPAIGN_SIM_ID)
    assert (cfg["standard"], cfg["rate"], cfg["z"], cfg["ptype"]) == ("802.16", "1/2", 27, "A")
    K = 27 * 12
    for snr in artifacts.CAMPAIGN_SNRS:
        [p] = [p for p in cfg["points"] if p["snr"] == snr]
        assert p["ber"] >= 3e-5
        rec = ("802.16", "1/2", 27, "A", snr, p["nblocks"], p["nblkerr"], p["nbits"],
               p["nbiterr"], p["niters"])
        table = artifacts.compare_campaign_point(cfg, rec)
        near = [r for r in cfg["reference_points"] if abs(r["snr"] - snr) <= 0.1]
        assert len(table) == 1 + len(near) >= 2 and all(c["ok"] for c in table)
        assert p["nbits"] == p["nblocks"] * K
        off = rec[:8] + (rec[7] // 10,) + rec[9:]          # BER 0.1
        assert not any(c["ok"] for c in artifacts.compare_campaign_point(cfg, off))


def test_run_sweep_rows_on_the_cpu():
    rows = artifacts.run_sweep_rows("modulated_sweep.json", [15.0], n_trials=2,
                                    device="cpu")
    assert len(rows) == 1 and rows[0]["snr"] == 15.0 and rows[0]["frames"] == 2
    assert rows[0]["awgn_var"] == 1.0 and {"ler", "ver"} <= set(rows[0])
    table = artifacts.compare_sweep("modulated_sweep.json", rows)
    assert [c["key"] for c in table] == ["fer", "ser"]
    with pytest.raises(KeyError):
        artifacts.run_sweep_rows("sc_sweep.json", [9.25], n_trials=2, device="cpu")


def test_run_campaign_point_on_the_cpu():
    cfg = artifacts.campaign_config(artifacts.CAMPAIGN_SIM_ID)
    small = dict(cfg, z=3, protocol=dict(cfg["protocol"], min_errors=1, batch=8,
                                         max_blocks=16, max_iters=10))
    rec = artifacts.run_campaign_point(small, 0.5, device="cpu")
    assert rec[:5] == ("802.16", "1/2", 3, "A", 0.5)
    assert rec[5] in (8, 16) and rec[7] == rec[5] * 36 and 0 <= rec[8] <= rec[7]
    assert np.isfinite(rec[8] / rec[7])
