"""The roofline arithmetic at the cells' shapes, and the readers on a
trace made by hand."""

import math

import pytest

from perfbench.drivers.sparc_mc import Driver
from perfbench.metrics import (amp_launches_per_iter, device_idle_share,
                               freeze_share, k1_roofline, k3_roofline,
                               select_sum_share)
from perfbench.peaks import FLOAT32_OPS_PER_S, HBM_BYTES_PER_S
from perfbench.run import BENCH, Run, load_json
from perfbench.trace import Trace


def work(cell):
    traffic = load_json(BENCH / "workloads" / f"{cell}.json")
    config = load_json(BENCH / "configs" / f"{traffic['config']}.json")
    return Driver(config, traffic, 0, "cpu").work()


FLAG = work("sparc_flagship.deep_6db")
SC = work("sparc_sc_large.wave_snr15")


def test_flagship_product():
    assert (FLAG["rows"], FLAG["E"], FLAG["w"], FLAG["n"]) == (256, 1, 2**19, 9216)
    nbytes = 4 * 256 * (2**19 + 9216) + 2**19 / 8
    assert nbytes / HBM_BYTES_PER_S * 1e3 == pytest.approx(0.163, abs=5e-4)
    # the adds at one a lane a clock, 33.5e12/s: twice the 0.038 ms of the FMA rate
    assert 256 * 2**19 * 19 / FLOAT32_OPS_PER_S * 1e3 == pytest.approx(0.076, abs=5e-4)
    assert k1_roofline.product_least_s(FLAG) * 1e3 == pytest.approx(0.163, abs=5e-4)


def test_k3_at_the_flagship_shape():
    assert k3_roofline.call_least_s(FLAG) * 1e3 == pytest.approx(0.6417, abs=1e-4)


def test_sc_product_counts_beta_and_y_not_the_selected_blocks():
    assert (SC["rows"], SC["E"], SC["w"], SC["LM"], SC["n"]) == (64, 192, 2**15, 2**20, 12284)
    own = 4 * 64 * (2**20 + 12284) + 192 * 2**15 / 8
    blocks = 4 * 64 * 192 * (2**15 + 332)        # the E-fold blocks after the select
    ops = 192 * 64 * 2**15 * 15
    least = k1_roofline.product_least_s(SC)
    assert least == pytest.approx(ops / FLOAT32_OPS_PER_S)      # operations-bound
    assert least * 1e3 == pytest.approx(0.180, abs=5e-4) and own / HBM_BYTES_PER_S < least
    assert 5 * own < blocks             # the count is of beta and y, not the blocks


def fake_run(work, kernels=None, ops=None, busy=0.5, window=1.0, launches=300, points=1):
    t = Trace(window_s=window, points=points, busy_s=busy, launches=launches,
              kernels=kernels or {}, ops=ops or {})
    return Run(work=work, trace=t)


def test_readers_on_a_trace():
    k1 = "void fwht_cluster_rows_kernel<1>(float const*, float const*, float*)"
    k2 = "void fwht2mm_wg_tile_kernel<15>(float const*)"
    k3 = "void denoise_update_kernel<512>(float const*)"
    run = fake_run(FLAG, kernels={k1: [58, 58 * 0.6e-3], k2: [3, 1.0],
                                  k3: [29, 29 * 0.8e-3]},
                   ops={"aten::where": 0.25, "aten::index_select": 0.05})
    assert k1_roofline.read(run) == pytest.approx(100 * 0.16309660 / 0.6, rel=1e-4)
    assert k3_roofline.read(run) == pytest.approx(100 * 0.64166591 / 0.8, rel=1e-4)
    assert freeze_share.read(run) == pytest.approx(50.0)
    assert select_sum_share.read(run) == pytest.approx(10.0)
    assert device_idle_share.read(run) == pytest.approx(50.0)
    assert amp_launches_per_iter.read(run) == pytest.approx(300 / (8 * 29))


@pytest.mark.parametrize("reader", [k1_roofline, k3_roofline, freeze_share,
                                    select_sum_share, device_idle_share,
                                    amp_launches_per_iter])
def test_a_reader_with_nothing_to_read_returns_none(reader):
    assert reader.read(fake_run(FLAG, busy=0.0, launches=0)) is None
    assert reader.read(Run(work=FLAG)) is None


def test_k1_launches_of_k2_do_not_count():
    run = fake_run(FLAG, kernels={"void fwht2mm_f32_tile_kernel<15>(float*)": [5, 1.0]})
    assert k1_roofline.read(run) is None
    assert math.isfinite(k1_roofline.product_least_s(SC))
