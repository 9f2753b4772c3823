"""The readers of the program's spans and counters (`design_build_idle_share`,
`mc_draws_idle_share`, `amp_live_row_share`) on a trace made by hand and a
patched counter registry, and, on the card, that the program's spans add
no device op to the trace the harness reduces."""

import sys
from collections import Counter

import pytest
import torch

from perfbench.metrics import (amp_live_row_share, design_build_idle_share,
                               mc_draws_idle_share)
from perfbench.run import Run
from perfbench.trace import Trace, summarize

TRACING = "ldpc_sparc_tpu_torch.utils.tracing"
HARNESS_GAP = "host in sparc_mc_counts, outside torch ops"
IDLE_READERS = [design_build_idle_share, mc_draws_idle_share]


def traced_run(gaps, window=2.0):
    return Run(trace=Trace(window_s=window, points=1, busy_s=1.0, launches=10,
                           gaps=[list(g) for g in gaps]))


def test_idle_shares_sum_the_gaps_their_spans_name():
    run = traced_run([("mc.designs", 0.2), ("aten::copy_", 0.05), ("mc.bits", 0.03),
                      ("mc.noise", 0.01), ("mc.decode", 0.004), (HARNESS_GAP, 0.1)])
    assert design_build_idle_share.read(run) == pytest.approx(10.0)
    assert mc_draws_idle_share.read(run) == pytest.approx(2.0)


@pytest.mark.parametrize("reader", IDLE_READERS)
def test_an_idle_share_reads_zero_where_no_gap_has_its_name(reader):
    assert reader.read(traced_run([(HARNESS_GAP, 0.5), ("aten::copy_", 0.1)])) == 0.0
    assert reader.read(traced_run([])) == 0.0


@pytest.mark.parametrize("reader", IDLE_READERS + [amp_live_row_share])
def test_a_reader_without_a_trace_returns_none(reader):
    assert reader.read(Run()) is None


@pytest.mark.parametrize("reader", IDLE_READERS + [amp_live_row_share])
def test_a_reader_of_a_program_without_spans_returns_none(reader, monkeypatch):
    monkeypatch.setitem(sys.modules, TRACING, None)       # the import then fails
    assert reader.read(traced_run([("mc.designs", 0.2), ("mc.bits", 0.1)])) is None


def test_live_row_share_reads_the_counters(monkeypatch):
    from ldpc_sparc_tpu_torch.utils import tracing
    run = traced_run([])
    monkeypatch.setattr(tracing, "_COUNTS", Counter({"amp.row_iters": 232,
                                                     "amp.live_row_iters": 116}))
    assert amp_live_row_share.read(run) == pytest.approx(50.0)
    monkeypatch.setattr(tracing, "_COUNTS", Counter({"k1.launches": 4}))
    assert amp_live_row_share.read(run) is None             # no AMP rows counted
    monkeypatch.setattr(tracing, "_COUNTS", Counter({"amp.row_iters": 9}))
    assert amp_live_row_share.read(run) == 0.0


@pytest.mark.cuda
def test_spans_add_no_device_op(card, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    from ldpc_sparc_tpu_torch import DecodeParams, SparcParams
    from ldpc_sparc_tpu_torch.parallel.montecarlo import sparc_mc_counts
    from ldpc_sparc_tpu_torch.utils import tracing

    params, decode = SparcParams(P=15.0, R=1.0, L=256, M=64), DecodeParams(t_max=12)

    def traced():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            counts = sparc_mc_counts(params, decode, 1.0, (7, 1), 64, device=card)
            torch.cuda.synchronize()
        names = Counter(e.name for e in prof.events())
        return counts, summarize(prof.events(), 1.0, 1), names

    sparc_mc_counts(params, decode, 1.0, (7, 1), 64, device=card)     # builds, warms
    with_spans, tr_spans, names = traced()
    assert names["mc.decode"] >= 8 and names["mc.designs"] >= 1
    monkeypatch.setattr(tracing, "span", lambda name: tracing._OFF)
    without, tr_plain, names = traced()
    assert names["mc.decode"] == 0
    assert with_spans == without
    assert tr_spans.launches == tr_plain.launches > 0
    assert {k: v[0] for k, v in tr_spans.kernels.items()} == \
        {k: v[0] for k, v in tr_plain.kernels.items()}
    assert tr_spans.busy_s == pytest.approx(tr_plain.busy_s, rel=0.25)
