"""The LDPC waterfall campaign at 802.11n r=1/2 z=81 against the
benchmark's plain reference (`perfbench/reference/ldpc.py`), and the
campaign loop's spans and counters. CPU, torch on one thread; imports no
JAX, so the card test at the end also runs where only the port is
installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_campaign_cell.py

The reference's table, encode and draws are the port's bit for bit; its BP
(which drops stopped codewords between iterations) gives the port's plain
BP's iterations and APP bit for bit on the CPU, and concat.py's `bp_decode`
likewise. On the card K4 is held to the plain path at the cell's shape as
`tests/test_torch_kernels.py` holds it elsewhere: iterations equal on
every codeword, decisions equal on every codeword that stopped by parity.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ldpc_sparc_tpu_torch import LdpcParams, get_code, ldpc_waterfall_campaign
from ldpc_sparc_tpu_torch.models.ldpc_tables import get_protograph
from ldpc_sparc_tpu_torch.ops import bp as tbp
from ldpc_sparc_tpu_torch.parallel import montecarlo
from ldpc_sparc_tpu_torch.utils import tracing
from perfbench.reference import concat as cref
from perfbench.reference import ldpc as ref

PARAMS = LdpcParams("802.11n", "1/2", 81, "A")
SEED = 2**31 + 41


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def codes():
    return ref.build_code(), get_code("802.11n", "1/2", 81)


# ---- the reference's code against the port's ---------------------------------------

def test_reference_table_is_the_ports(codes):
    rcode, code = codes
    np.testing.assert_array_equal(ref.protograph(), get_protograph("802.11n", "1/2", 81))
    assert (rcode.N, rcode.K, len(rcode.row) * rcode.z) == (code.N, code.K, 6966)
    assert ref.check_degrees(rcode) == [7] * 6 + [8] + [7] * 4 + [8]


@pytest.mark.parametrize("batch", [1, 37])
def test_reference_encode_is_the_ports(codes, batch):
    rcode, code = codes
    info = np.random.default_rng(batch).integers(0, 2, (batch, code.K))
    want = code.encode(torch.as_tensor(info)).numpy()
    np.testing.assert_array_equal(rcode.encode(info), want)
    np.testing.assert_array_equal(rcode.parity(info), code.parity_chain(info))


def test_reference_refuses_another_code():
    with pytest.raises(ValueError, match="z=81"):
        ref.build_code({"standard": "802.11n", "rate": "1/2", "z": 27})


@pytest.mark.parametrize("snr_db,max_iters", [(1.0, 40), (1.6, 200)])
def test_reference_bp_is_the_ports_plain_bp(codes, snr_db, max_iters):
    """Seeded LLRs of 16 codewords, some at the cap: iterations and APP of
    the reference's BP equal the port's plain BP's and concat.py's."""
    rcode, code = codes
    _, llr = ref.batch_llrs(rcode, snr_db, SEED, [512], 16, "cpu")
    app, iters = ref.bp_decode(llr, rcode, max_iters)
    want = tbp.bp_decode(llr, code.graph, max_iters, "sumprod", bp_kernel=False)
    assert torch.equal(iters, want.iterations.long())
    assert torch.equal(app, want.app)
    app2, iters2 = cref.bp_decode(llr, rcode, max_iters)
    assert torch.equal(iters, iters2) and torch.equal(app, app2)
    if max_iters == 40:
        assert 0 < int((iters == max_iters).sum()) < 16     # both kinds of codeword


def test_bfloat16_messages_move_the_decode(codes):
    rcode, _ = codes
    _, llr = ref.batch_llrs(rcode, 1.0, SEED, [0], 8, "cpu")
    app, iters = ref.bp_decode(llr, rcode, 40)
    low, low_iters = ref.bp_decode(llr, rcode, 40, torch.bfloat16)
    assert low.dtype == torch.float32 and not torch.equal(app, low)
    assert low_iters.shape == iters.shape


def test_reference_batch_counts_are_the_programs(codes):
    """A batch's draws, encode, channel and counts: the program's
    `_batch_counts` and the reference read the same (bit errors, block
    errors, iterations)."""
    rcode, code = codes
    ctr = 3 * 16
    got = montecarlo._batch_counts(code, 1.2, montecarlo._batch_generator(SEED, ctr, "cpu"),
                                   16, 30, "sumprod2", True).tolist()
    x, llr = ref.batch_llrs(rcode, 1.2, SEED, [ctr], 16, "cpu")
    app, iters = ref.bp_decode(llr, rcode, 30)
    biterrs = (x != (app < 0).long()).sum(1)
    assert got == [int(biterrs.sum()), int((biterrs > 0).sum()), int(iters.sum())]
    want = ref.point_counts({"standard": "802.11n", "rate": "1/2", "z": 81,
                             "max_iters": 30}, 1.2, SEED, ctr, 16, 16, "cpu")
    assert [want["bit_errs"], want["errs"], want["iters"]] == got


def test_point_counts_take_whole_batches():
    with pytest.raises(ValueError, match="whole batches"):
        ref.point_counts({"standard": "802.11n", "rate": "1/2", "z": 81, "max_iters": 5},
                         1.6, 0, 0, 24, 16, "cpu")


# ---- the campaign loop's counters and spans -----------------------------------------

SMALL = dict(n_measurements=2, min_errors=10**6, max_blocks=48, batch=16,
             dectype="sumprod2", max_iters=20, start_snr=1.2, device="cpu")
TRACED = {**SMALL, "n_measurements": 1, "max_blocks": 32, "max_iters": 10}
CAMPAIGN = ("campaign.points", "campaign.batches", "campaign.batches_discarded",
            "campaign.codeword_iters")


@pytest.mark.parametrize("pipelined", [True, False])
def test_campaign_counters(pipelined):
    tracing.reset(*CAMPAIGN)
    recs = ldpc_waterfall_campaign(PARAMS, seed=SEED, pipelined=pipelined, **SMALL)
    c = tracing.counters()
    points, per_point = len(recs), SMALL["max_blocks"] // SMALL["batch"]
    assert points == 2 and c["campaign.points"] == points
    assert c["campaign.batches"] == points * (per_point + pipelined)
    assert c["campaign.batches_discarded"] == (points if pipelined else 0)
    assert c["campaign.codeword_iters"] == sum(r[9] for r in recs) > 0


def test_counters_leave_the_records_alone():
    """The records are the same pipelined and serial, and with the
    profiler on."""
    piped = ldpc_waterfall_campaign(PARAMS, seed=SEED, **TRACED)
    serial = ldpc_waterfall_campaign(PARAMS, seed=SEED, pipelined=False, **TRACED)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = ldpc_waterfall_campaign(PARAMS, seed=SEED, **TRACED)
    assert piped == serial == traced


@pytest.mark.parametrize("pipelined", [True, False])
def test_campaign_spans(pipelined):
    """Each batch takes the five `mc.*` spans, the speculative one too;
    each counted batch one `campaign.read`, under the caller's span."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            recs = ldpc_waterfall_campaign(PARAMS, seed=SEED, pipelined=pipelined, **TRACED)
    per_point = TRACED["max_blocks"] // TRACED["batch"]
    names = Counter(e.name for e in prof.events())
    dispatched = len(recs) * (per_point + pipelined)
    for span in ("mc.bits", "mc.noise", "mc.encode", "mc.decode", "mc.count"):
        assert names[span] == dispatched, span
    assert names["campaign.read"] == len(recs) * per_point
    caller = next(e for e in prof.events() if e.name == "caller")
    reads = [e for e in prof.events() if e.name == "campaign.read"]
    assert all(caller.time_range.start <= e.time_range.start
               and e.time_range.end <= caller.time_range.end for e in reads)


# ---- on the card ---------------------------------------------------------------------

@pytest.mark.cuda
def test_k4_matches_the_plain_path_at_the_cells_shape(codes):
    """The cell's decode: 512 codewords of 802.11n r=1/2 z=81 at 1.6 dB,
    sum-product, at most 200 iterations, through K4 (check_thread, one
    block an SM) against the plain path, over 8 batches of the campaign's
    draws: iterations equal on every codeword, decisions equal on every
    codeword that stopped by parity; and the plain path's iterations are
    the reference BP's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K4 runs only on the card")
    from ldpc_sparc_tpu_torch.ops import bp_cuda
    rcode, code = codes
    dev = torch.device("cuda")
    assert bp_cuda.k4_variant(code.graph) == "check_thread"
    for b in range(8):
        _, llr = ref.batch_llrs(rcode, 1.6, SEED, [b * 512], 512, dev)
        llr = llr.contiguous()
        got = bp_cuda.bp_decode_kernel(llr, code.graph, 200, True, 0.7)
        want = bp_cuda.bp_decode_ref(llr, code.graph, 200, True, 0.7)
        _, ref_iters = ref.bp_decode(llr, rcode, 200)
        assert torch.equal(got.iterations, want.iterations)
        assert torch.equal(ref_iters, want.iterations.long())
        stopped = want.iterations < 200
        assert torch.equal(got.app[stopped] < 0, want.app[stopped] < 0)
