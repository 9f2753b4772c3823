"""The Monte Carlo point's designs drawn on a host thread ahead of the decode
(`parallel/montecarlo.py::_designs_ahead`) and uploaded without a host sync
(`ops/transforms.py::HostDesign`).

On the CPU: the uploaded designs equal `for_params`' and the leaves of a
design made from device tensors, bit for bit (a flagship-shaped SRHT design,
the SC design of the benchmark's `sparc_sc_large`, a DFT design); a point
counts what the designs built and decoded one by one count; a draw's error
reaches the caller; no thread outlives the point; the point's counters and
the benchmark's reader of them. On the card (marked `cuda`): the upload
makes no host sync, and a point holds at most two designs at once. Imports
no JAX."""

import json
import sys
import threading
import weakref
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from ldpc_sparc_tpu_torch import DecodeParams, SparcParams
from ldpc_sparc_tpu_torch.models.sparc import awgn_channel, decode_batch
from ldpc_sparc_tpu_torch.ops import transforms as ttr
from ldpc_sparc_tpu_torch.parallel import montecarlo as tmc
from ldpc_sparc_tpu_torch.utils import bits as bitops
from ldpc_sparc_tpu_torch.utils import rng as rngmod
from ldpc_sparc_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _config_params(name: str) -> SparcParams:
    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())
    keys = ("P", "R", "L", "M", "spatially_coupled", "omega", "Lambda")
    return SparcParams(**{k: cfg[k] for k in keys if k in cfg})


DESIGNS = {   # params, awgn_var, engine, designs checked
    "flagship": (_config_params("sparc_flagship"), 2.5, "srht", 3),
    "sc": (_config_params("sparc_sc_large"), 1.0, "srht", 2),
    "dft": (SparcParams(P=15.0, R=1.0, L=64, M=16, is_complex=True), 1.0, "dft", 3),
}
POINTS = {    # params, awgn_var: some trials stop early, some run to the cap
    "plain": (SparcParams(P=15.0, R=1.3, L=64, M=16), 1.0),
    "sc": (SparcParams(P=15.0, R=1.2, L=64, M=16, spatially_coupled=True,
                       omega=2, Lambda=8), 1.0),
}
DECODE = DecodeParams(t_max=10)


def _taken(params, awgn_var, seed, count, engine, device=CPU):
    with tmc._designs_ahead(params, awgn_var, seed, count, engine, device) as take:
        return [take(d) for d in range(count)]


def _same_tensor(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _assert_srht_equal(got, want):
    for f in ("rows", "cols", "Lr", "Lc", "Mr", "Mc", "w", "n", "LM", "offset"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("idx", "signs", "scale", "_idx32", "_rows_t", "_cols_t"):
        assert _same_tensor(getattr(got, f), getattr(want, f)), f
    for f in ("_col_ptr", "_col_blocks"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None and w is None) or _same_tensor(g, w), f


@pytest.mark.parametrize("name", DESIGNS)
def test_taken_designs_equal_for_params_bit_for_bit(name):
    params, awgn_var, engine, count = DESIGNS[name]
    seed = (2 ** 31 + 5, 3)
    cls = ttr.design_class(engine)
    for d, got in enumerate(_taken(params, awgn_var, seed, count, engine)):
        want = cls.for_params(params, awgn_var, (seed, d), CPU)
        assert type(got) is cls
        if engine == "dft":
            assert (got.w, got.n, got.LM, got.scale) == (want.w, want.n, want.LM,
                                                         want.scale)
            assert _same_tensor(got.rows, want.rows)
            assert _same_tensor(got.cols, want.cols)
            continue
        _assert_srht_equal(got, want)
        # the design made from device tensors, as the draw made it before it
        # moved to the host: its own range check, index tables and segments
        rows, cols, idx, signs = ttr.generate_block_randomness(
            ttr.create_base_matrix(params, awgn_var), got.Mr, got.Mc, got.w,
            (seed, d), got.offset)
        on_device = ttr.SparcDesign(
            torch.as_tensor(idx, dtype=torch.int64), torch.as_tensor(signs),
            got.scale.clone(), tuple(int(r) for r in rows),
            tuple(int(c) for c in cols), got.Lr, got.Lc, got.Mr, got.Mc, got.w,
            got.n, got.LM, got.offset)
        _assert_srht_equal(got, on_device)
        if name == "sc":
            assert got.E == 192 and got._col_ptr is not None


def _loop_randomness(W, Mr, Mc, w, seed, offset):
    """The block draws as the JAX package writes them: per block, in row
    order, `rng.choice` sorted, then `rng.integers(0, 2, large)` as +-1."""
    rng = np.random.default_rng(seed)
    small, large = min(Mr, Mc), max(Mr, Mc)
    if offset == 0:
        base = np.arange(0, w, dtype=np.int32)
    else:
        Q = 1 << int(np.floor(np.log2(large)))
        while Q <= small:
            Q *= 2
        base = np.arange(1, min(Q, w), dtype=np.int32)
    rows, cols, idxs, sgns = [], [], [], []
    for r in range(W.shape[0]):
        for c in range(W.shape[1]):
            if W[r, c] != 0:
                rows.append(r)
                cols.append(c)
                idxs.append(np.sort(rng.choice(base, small, replace=False)))
                sgns.append(rng.integers(0, 2, large).astype(np.float32) * 2 - 1)
    return (np.array(rows, dtype=np.int32), np.array(cols, dtype=np.int32),
            np.stack(idxs), np.stack(sgns)), rng


@pytest.mark.parametrize("shape", [
    (np.ones((2, 3)), 12, 32, 32, 0),            # even window, offset 0
    (np.ones((3, 2)), 21, 17, 32, 1),            # odd window: rows one short
    (np.eye(4) + np.eye(4, k=1), 33, 7, 64, 1),  # tall, odd window of 33
    (np.ones((1, 1)), 9, 1024, 1024, 0),
])
@pytest.mark.parametrize("seed", [0, (3, 1), 2 ** 40 + 17])
def test_block_draws_read_the_stream_as_the_loop_does(shape, seed):
    W, Mr, Mc, w, offset = shape
    (rows, cols, idx, signs), rng = _loop_randomness(W, Mr, Mc, w, seed, offset)
    got = ttr.generate_block_randomness(W, Mr, Mc, w, seed, offset)
    for a, b in zip(got, (rows, cols, idx, signs)):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    _, _, _, words, held = ttr.block_draws(W, Mr, Mc, w, seed, offset)
    assert words.dtype == np.uint64 and words.shape == (len(rows), (max(Mr, Mc) + 1) // 2)
    assert held.dtype == np.int64 and held.shape == (len(rows),)


@pytest.mark.parametrize("count", [1, 2, 31, 32, 33, 1024])
@pytest.mark.parametrize("before", [0, 1, 2])     # 32-bit draws made before
def test_sign_words_take_what_integers_takes(count, before):
    """`_sign_words` returns integers(0, 2, count)'s draws and leaves the
    stream where that call leaves it, with or without a held half."""
    loop, words = np.random.default_rng(11), np.random.default_rng(11)
    for rng in (loop, words):
        rng.integers(0, 7, before)
    want = loop.integers(0, 2, count).astype(np.float32) * 2 - 1
    held, raw = ttr._sign_words(words.bit_generator, count)
    assert (held >= 0) == bool(before % 2)
    padded = np.zeros((count + 1) // 2, dtype=np.uint64)
    padded[:len(raw)] = raw
    got = ttr.signs_from_words(torch.from_numpy(padded.view(np.int64))[None],
                               torch.tensor([held]), count)[0]
    assert np.array_equal(got.numpy(), want)
    a, b = loop.bit_generator.state, words.bit_generator.state
    assert (a["state"], a["has_uint32"]) == (b["state"], b["has_uint32"])
    assert not a["has_uint32"] or a["uinteger"] == b["uinteger"]   # else unread
    assert loop.integers(0, 1000, 5).tolist() == words.integers(0, 1000, 5).tolist()


def test_the_host_draw_checks_the_index_set(monkeypatch):
    real = ttr.block_draws

    def out_of_range(W, Mr, Mc, w, seed, offset=1):
        rows, cols, idx, words, held = real(W, Mr, Mc, w, seed, offset)
        idx[0, -1] = w
        return rows, cols, idx, words, held

    monkeypatch.setattr(ttr, "block_draws", out_of_range)
    params, awgn_var = POINTS["sc"]
    with pytest.raises(ValueError, match="outside"):
        ttr.SparcDesign.draw_for_params(params, awgn_var, 0)


def _one_by_one(params, awgn_var, seed, n_trials, n_designs):
    """The point's counters from designs built one by one with `for_params`
    and decoded in design order, as `sparc_mc_counts` decodes them."""
    M, K, L = params.M, params.K, params.L
    totals = torch.zeros(4, dtype=torch.int64)
    for d in range(n_designs):
        design = ttr.SparcDesign.for_params(params, awgn_var, (seed, d), CPU)
        gens = [rngmod.root_generator(rngmod.derive(seed, t), CPU)
                for t in range(d, n_trials, n_designs)]
        bits = torch.stack([bitops.random_bits(g, params.bit_len) for g in gens])
        beta0 = bitops.bits_to_msg_vector(bits, M, K)
        x = design.ab(beta0)
        y = torch.stack([awgn_channel(xi, awgn_var, g) for xi, g in zip(x, gens)])
        beta, t_final = decode_batch(y, design, params, DECODE, awgn_var)
        bit_errs = (bitops.msg_vector_to_bits(beta, M, K) != bits).sum(-1)
        sec_e = (beta != beta0).reshape(-1, L, M).any(-1)
        totals += torch.stack([bit_errs.sum(), sec_e.sum(), (bit_errs > 0).sum(),
                               t_final.sum()])
    be, se, fe, it = totals.tolist()
    return {"bit_errs": be, "bits": n_trials * params.bit_len, "sec_errs": se,
            "sections": n_trials * L, "frame_errs": fe, "frames": n_trials,
            "iters": it}


@pytest.mark.parametrize("n_trials,n_designs", [(16, None), (12, 4)])
@pytest.mark.parametrize("name", POINTS)
def test_point_counts_equal_designs_decoded_one_by_one(name, n_trials, n_designs):
    params, awgn_var = POINTS[name]
    seed = (2 ** 33 + 1, 7)
    got = tmc.sparc_mc_counts(params, DECODE, awgn_var, seed, n_trials, n_designs,
                              device="cpu")
    assert got == _one_by_one(params, awgn_var, seed, n_trials,
                              n_designs or min(8, n_trials))


def test_a_draw_error_reaches_the_caller_and_no_thread_outlives_it(monkeypatch):
    params, awgn_var = POINTS["plain"]
    real = ttr.SparcDesign.draw_for_params.__func__
    drawn = []

    def failing(cls, params, awgn_var, seed, pin=False):
        drawn.append(seed[1])
        if seed[1] == 3:
            raise RuntimeError("draw of design 3 failed")
        return real(cls, params, awgn_var, seed, pin)

    before = threading.active_count()
    monkeypatch.setattr(ttr.SparcDesign, "draw_for_params", classmethod(failing))
    with pytest.raises(RuntimeError, match="design 3"):
        tmc.sparc_mc_counts(params, DECODE, awgn_var, 5, 16, 8, device="cpu")
    assert threading.active_count() == before
    assert drawn[:4] == [0, 1, 2, 3] and max(drawn) <= 4   # never more than two ahead


def test_a_decode_error_ends_the_thread(monkeypatch):
    params, awgn_var = POINTS["plain"]

    def failing(*args, **kwargs):
        raise RuntimeError("decode failed")

    before = threading.active_count()
    monkeypatch.setattr(tmc, "decode_batch", failing)
    with pytest.raises(RuntimeError, match="decode failed"):
        tmc.sparc_mc_counts(params, DECODE, awgn_var, 5, 16, 8, device="cpu")
    assert threading.active_count() == before


@pytest.mark.parametrize("n_trials,n_designs", [(16, None), (12, 4), (1, None)])
def test_a_point_counts_its_designs(n_trials, n_designs):
    params, awgn_var = POINTS["sc"]
    before = threading.active_count()
    start = tracing.counters()
    tmc.sparc_mc_counts(params, DECODE, awgn_var, 9, n_trials, n_designs, device="cpu")
    end = tracing.counters()
    d = n_designs or min(8, n_trials)
    assert end["mc.designs_built"] - start["mc.designs_built"] == d
    assert 1 <= end["mc.designs_waited"] - start["mc.designs_waited"] <= d
    assert threading.active_count() == before


def test_design_ready_share_reads_the_counters(monkeypatch):
    from perfbench.metrics import design_ready_share
    from perfbench.run import Run
    from perfbench.trace import Trace

    traced = Run(trace=Trace(window_s=2.0, points=1))
    monkeypatch.setattr(tracing, "_COUNTS", Counter({"mc.designs_built": 16,
                                                     "mc.designs_waited": 3}))
    assert design_ready_share.read(Run()) is None          # no trace
    assert design_ready_share.read(traced) == pytest.approx(100.0 * 13 / 16)
    monkeypatch.setattr(tracing, "_COUNTS", Counter({"amp.row_iters": 9}))
    assert design_ready_share.read(traced) is None         # no design counted
    monkeypatch.setitem(sys.modules, "ldpc_sparc_tpu_torch.utils.tracing", None)
    assert design_ready_share.read(traced) is None         # a program without counters


# ---- on the card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the upload without a sync is the card's")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", DESIGNS)
def test_upload_makes_no_host_sync(card, name):
    params, awgn_var, engine, _ = DESIGNS[name]
    host = ttr.design_class(engine).draw_for_params(params, awgn_var, (4, 0), pin=True)
    assert all(t.is_pinned() for t in host.leaves.values())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        design = host.upload(card)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = ttr.design_class(engine).for_params(params, awgn_var, (4, 0), CPU)
    if engine == "dft":
        assert torch.equal(design.rows.cpu(), want.rows)
    else:
        assert design.device.type == "cuda"
        assert torch.equal(design.signs.cpu(), want.signs)
        assert torch.equal(design._idx32.cpu(), want._idx32)
        assert torch.equal(design._index.cpu(), want._index)


@pytest.mark.cuda
def test_a_point_holds_at_most_two_designs(card, monkeypatch):
    params, awgn_var = DESIGNS["sc"][0], DESIGNS["sc"][1]
    decode = DecodeParams(t_max=6)
    live, most = [], []
    upload = ttr.HostDesign.upload

    def counted(self, device):
        design = upload(self, device)
        live.append(weakref.ref(design.signs))
        most.append(sum(r() is not None for r in live))
        return design

    def peak(n_trials, n_designs):
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tmc.sparc_mc_counts(params, decode, awgn_var, 11, n_trials, n_designs,
                            device=card)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - start

    tmc.sparc_mc_counts(params, decode, awgn_var, 11, 8, 2, device=card)   # builds
    two = peak(8, 2)                         # 4 rows a design, as below
    monkeypatch.setattr(ttr.HostDesign, "upload", counted)
    eight = peak(32, 8)
    signs = 192 * 32768 * 4                  # one design's signs
    assert len(most) == 8 and max(most) <= 2
    assert eight - two < signs               # all eight held would add 6 of them
