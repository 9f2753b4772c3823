"""The port's spans and counters (`ldpc_sparc_tpu_torch/utils/tracing.py`)
on the CPU: the spans of one Monte Carlo point under a CPU profiler, the
AMP loop's row counters against the counters `sparc_mc_counts` returns,
and the registry itself. Imports no JAX."""

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ldpc_sparc_tpu_torch import DecodeParams, SparcParams
from ldpc_sparc_tpu_torch.parallel.montecarlo import sparc_mc_counts
from ldpc_sparc_tpu_torch.utils import tracing

DECODE = DecodeParams(t_max=10)
POINTS = {   # params, awgn_var: some trials stop early, some run to the cap
    "plain": (SparcParams(P=15.0, R=1.3, L=64, M=16), 1.0),
    "sc": (SparcParams(P=15.0, R=1.2, L=64, M=16, spatially_coupled=True,
                       omega=2, Lambda=8), 1.0),
}
SIZES = [(16, None), (12, 4)]          # (n_trials, n_designs)
CALLER = "caller of sparc_mc_counts"


def point(name, n_trials, n_designs, seed=3):
    params, awgn_var = POINTS[name]
    return sparc_mc_counts(params, DECODE, awgn_var, seed, n_trials, n_designs,
                           device="cpu")


def test_span_without_a_profiler_is_the_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    off = tracing.span("mc.designs")
    assert off is tracing.span("mc.decode") is tracing._OFF
    with off:
        with tracing.span("mc.count"):
            pass


@pytest.mark.parametrize("n_trials,n_designs", SIZES)
@pytest.mark.parametrize("name", POINTS)
def test_a_point_records_its_spans_under_the_caller(name, n_trials, n_designs):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            point(name, n_trials, n_designs)
    spans = [e for e in prof.events() if e.name.startswith("mc.")]
    d = n_designs or min(8, n_trials)
    assert Counter(e.name for e in spans) == {
        "mc.designs": d, "mc.bits": d, "mc.encode": d, "mc.noise": d,
        "mc.decode": d, "mc.count": d + 1}
    assert all(e.cpu_parent is not None and e.cpu_parent.name == CALLER
               for e in spans)
    assert all(e.is_user_annotation for e in spans)


@pytest.mark.parametrize("n_trials,n_designs", SIZES)
@pytest.mark.parametrize("name", POINTS)
def test_amp_row_counters_match_the_point(name, n_trials, n_designs):
    before = tracing.counters()
    counts = point(name, n_trials, n_designs)
    after = tracing.counters()
    row_iters = after["amp.row_iters"] - before["amp.row_iters"]
    live = after["amp.live_row_iters"] - before["amp.live_row_iters"]
    assert live == counts["iters"]
    assert row_iters == n_trials * (DECODE.t_max - 1)
    assert 0 < live < row_iters          # the loop ran rows that had stopped


def test_the_counters_count_the_same_under_a_profiler():
    before = tracing.counters()
    quiet = point("plain", 16, None)
    mid = tracing.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = point("plain", 16, None)
    after = tracing.counters()
    assert traced == quiet
    for key in ("amp.row_iters", "amp.live_row_iters"):
        assert after[key] - mid[key] == mid[key] - before[key]


def test_count_counters_and_reset():
    tracing.reset()
    assert tracing.counters() == {}
    tracing.count("k1.launches")
    tracing.count("k1.launches", 2)
    tracing.count("amp.row_iters", 7)
    got = tracing.counters()
    assert got == {"k1.launches": 3, "amp.row_iters": 7}
    assert got["k4.launches"] == 0                  # never counted
    got["k1.launches"] = 100                        # a copy
    assert tracing.counters()["k1.launches"] == 3
    tracing.reset("k1.launches")
    assert tracing.counters() == {"amp.row_iters": 7}
    tracing.reset()
    assert tracing.counters() == {} and tracing.counters()["amp.row_iters"] == 0
