"""The concatenated Monte Carlo point with its soft outputs
(`concat_mc_counts`) against the benchmark's plain reference
(`perfbench/reference/concat.py`), the reference's copies of the code's
tables against the port's, the point's spans and counters, and the M = 2
identity of the two Onsager terms. CPU, torch on one thread, float32
matmuls at full precision; imports no JAX.

The reference sums its Walsh-Hadamard transform in another order than the
port's plain transform (radix 32 from the low bits against the port's
Kronecker chain from the high bits), a difference of about 1e-7 of a
value. Over a decode that difference stays at 1e-6 of tau^2, but a trial
on the edge of decoding amplifies it into another BP stop or another
decision (8 of 256 trials at these sizes). So the per-trial comparison
swaps the port's plain transform into the reference's design: every other
operation is the reference's own, and errors and BP iterations must then
be equal and tau^2 equal to rtol 1e-6 (they are equal bit for bit here;
the rtol leaves room for a library that vectorises the sums |z|^2 and
sum(eta') otherwise). The reference's own transform is held apart, tau^2
to rtol 1e-5 on every trial.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from ldpc_sparc_tpu_torch import (ConcatCodec, DecodeParams, LdpcParams, SparcParams,
                                  concat_ber_point, concat_mc_counts,
                                  concat_mc_trial_errors, get_code, param_calc)
from ldpc_sparc_tpu_torch.models.concat import amp_steps
from ldpc_sparc_tpu_torch.models.ldpc_tables import get_protograph
from ldpc_sparc_tpu_torch.ops import bp as tbp
from ldpc_sparc_tpu_torch.ops import wht
from ldpc_sparc_tpu_torch.utils import tracing
from perfbench.reference import concat as ref
from perfbench.reference import sparc as ref_sparc

P = 19.44


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


def _cfg(z=24, mults=1, t_max=6, logM=1, decoder="integrated"):
    """The cell's configuration at a small size."""
    return dict(standard="802.16", rate="1/2", z=z, mults=mults, logM=logM, P=P, R=1.0,
                t_max=t_max, bp_inner_iters=6, bp_final_iters=200, decoder=decoder)


def _program(cfg, snr, seed, n_trials, n_designs, decoder=None, **kw):
    ldpc = LdpcParams("802.16", "1/2", cfg["z"])
    _, _, L, lengths = param_calc(cfg["mults"], cfg["logM"], ldpc, 0.5, cfg["R"],
                                  get_code("802.16", "1/2", cfg["z"]).K)
    sp = SparcParams(P=P, R=cfg["R"], L=L, M=1 << cfg["logM"])
    return concat_mc_counts(sp, ldpc, lengths, True, DecodeParams(t_max=cfg["t_max"]),
                            P / snr, seed, n_trials, decoder or cfg["decoder"],
                            n_designs=n_designs, device="cpu", **kw)


@pytest.mark.parametrize("snr,seed", [(3.8, (0, 3)), (3.2, (2**31 + 5, 3))])
@pytest.mark.parametrize("mults", [1, 2])
@pytest.mark.parametrize("decoder", ["integrated", "naive"])
def test_program_equals_the_reference_per_trial(decoder, mults, snr, seed, monkeypatch):
    monkeypatch.setattr(ref_sparc, "fwht", wht.fwht)
    cfg = _cfg(mults=mults, decoder=decoder)
    got = _program(cfg, snr, seed, 8, 3)
    want = ref.point_outputs(cfg, P / snr, seed, 8, 3, "cpu")
    np.testing.assert_array_equal(got["errs"], want["errs"])
    np.testing.assert_array_equal(got["bp_iters"], want["bp_iters"])
    np.testing.assert_allclose(got["tau_sqr"], want["tau_sqr"], rtol=1e-6, atol=0)
    assert got["tau_sqr"].shape == (8, cfg["t_max"]) and got["bp_iters"].min() > 0


@pytest.mark.parametrize("mults", [1, 2])
def test_the_references_own_transform_moves_tau_by_rounding(mults):
    cfg = _cfg(mults=mults)
    got = _program(cfg, 3.2, (7, 1), 6, 3)
    want = ref.point_outputs(cfg, P / 3.2, (7, 1), 6, 3, "cpu")
    np.testing.assert_allclose(got["tau_sqr"], want["tau_sqr"], rtol=1e-5, atol=0)


def test_a_point_below_the_threshold_counts_errors_and_caps():
    got = _program(_cfg(), 2.5, (1, 0), 4, 2)
    assert (got["errs"] > 0).all() and got["frame_errs"] == 4
    assert (got["bp_iters"] == 5 * 6 + 200).all()        # every BP call at its cap
    assert got["bit_errs"] == got["errs"].sum() and got["bits"] == 4 * 288


# ---- the reference's copies of the code's tables -----------------------------------

@pytest.mark.parametrize("z", [24, 150])
def test_reference_code_tables_equal_the_ports(z):
    code, mine = get_code("802.16", "1/2", z), ref.Code.build(z)
    np.testing.assert_array_equal(ref.protograph(), get_protograph("802.16", "1/2", z))
    g = code.graph
    np.testing.assert_array_equal(mine.row, g.edge_row)
    np.testing.assert_array_equal(mine.col, g.edge_col)
    np.testing.assert_array_equal(mine.shift, g.edge_shift)
    assert (mine.K, mine.N) == (code.K, code.N)
    info = np.random.default_rng(z).integers(0, 2, (5, code.K))
    np.testing.assert_array_equal(mine.parity(info), code.parity_chain(info))
    np.testing.assert_array_equal(mine.encode(info), code.encode(torch.as_tensor(info)).numpy())
    H = code.pcmat()
    assert not ((mine.encode(info) @ H.T) % 2).any()


@pytest.mark.parametrize("max_iters", [1, 6, 60])
def test_reference_bp_equals_the_ports_plain_decode(max_iters):
    code = get_code("802.16", "1/2", 24)
    gen = torch.Generator().manual_seed(max_iters)
    x = torch.as_tensor(code.encode(torch.randint(0, 2, (6, code.K), generator=gen)))
    llr = 2.0 / 0.6 * ((1.0 - 2.0 * x) + 0.6 ** 0.5 * torch.randn(x.shape, generator=gen))
    app, iters = ref.bp_decode(llr.float(), ref.Code.build(24), max_iters)
    want = tbp.bp_decode(llr.float(), code.graph, max_iters, bp_kernel=False)
    assert torch.equal(app, want.app) and iters.tolist() == want.iterations.tolist()


# ---- the program's entry points ------------------------------------------------------

def _setup(z=24, mults=2):
    ldpc = LdpcParams("802.16", "1/2", z)
    _, _, L, lengths = param_calc(mults, 1, ldpc, 0.5, 1.0, get_code("802.16", "1/2", z).K)
    return SparcParams(P=P, R=1.0, L=L, M=2), ldpc, lengths


@pytest.mark.parametrize("decoder", ["sequential", "integrated"])
def test_trial_errors_and_ber_point_read_the_counts(decoder):
    sp, ldpc, lengths = _setup()
    args = (sp, ldpc, lengths, True, DecodeParams(t_max=6), P / 3.0, (4, 0), 6, decoder)
    counts = concat_mc_counts(*args, device="cpu")
    np.testing.assert_array_equal(concat_mc_trial_errors(*args, device="cpu"), counts["errs"])
    row = concat_ber_point(*args, device="cpu")
    ubits = ConcatCodec(sp, ldpc, lengths, True).user_bits_len
    assert row["bit_errs"] == counts["bit_errs"] == int(counts["errs"].sum())
    assert row["frame_errs"] == counts["frame_errs"] and row["frames"] == counts["frames"] == 6
    assert row["bits"] == counts["bits"] == 6 * ubits
    assert row["ber_max"] == counts["errs"].max() / ubits


@pytest.mark.parametrize("decoder", ["amp_only", "sequential", "sequential_rerun",
                                     "naive", "integrated_posteriors"])
def test_soft_outputs_of_every_decoder_family(decoder):
    sp, ldpc, lengths = _setup()
    protected = decoder != "amp_only"
    codec = ConcatCodec(sp, ldpc, lengths, protected)
    got = concat_mc_counts(sp, ldpc, lengths, protected, DecodeParams(t_max=5), P / 3.0,
                           (2, 1), 4, decoder, device="cpu")
    assert got["tau_sqr"].shape == (4, amp_steps(decoder, 5))
    assert got["tau_sqr"].dtype == np.float32 and (got["tau_sqr"] > 0).all()
    calls = {"amp_only": 0, "sequential": 1, "sequential_rerun": 1}.get(decoder, 5)
    assert (got["bp_iters"] <= calls * lengths.mults * 200).all()
    assert (got["bp_iters"] == 0).all() == (decoder == "amp_only")
    # the first step's tau^2 is |y|^2 / n
    from ldpc_sparc_tpu_torch.parallel.montecarlo import (concat_mc_designs,
                                                          concat_mc_transmit)
    designs = concat_mc_designs(codec, (2, 1), 4, device="cpu")
    _, ys = concat_mc_transmit(codec, designs, P / 3.0, (2, 1))
    np.testing.assert_allclose(got["tau_sqr"][:, 0], ((ys ** 2).sum(-1) / codec.n).numpy(),
                               rtol=1e-6)


def test_decode_soft_decides_as_decode():
    sp, ldpc, lengths = _setup()
    codec = ConcatCodec(sp, ldpc, lengths, True)
    design = codec.build_design((3, 0), device="cpu")
    gen = torch.Generator().manual_seed(3)
    _, _, beta0 = codec.encode_message(gen)
    y = torch.stack([design.ab(beta0 / codec.c_amp) + torch.randn(codec.n, generator=gen)
                     * (P / 3.5) ** 0.5 for _ in range(3)])
    soft = codec.decode_soft(y, design, DecodeParams(t_max=6), "integrated")
    assert torch.equal(soft.bits, codec.decode(y, design, DecodeParams(t_max=6), "integrated"))
    assert soft.tau_sqr.shape == (3, 6) and soft.bp_iters.dtype == torch.int64


def test_at_m2_the_integrated_onsager_term_is_the_standard_one():
    """With M = 2, sum(eta') of the BP-composed denoiser is 2 (c^2 / tau^2)
    v (1 - v) a section, which is n (P - |beta|^2 / n) / tau^2: the
    integrated and naive decoders are one function and differ by rounding
    (the 1e-6 clip inside the derivative aside). At M = 4 they part."""
    for logM, same in ((1, True), (2, False)):
        cfg = _cfg(mults=2, t_max=10, logM=logM)
        a = _program(cfg, 3.8, (5, 0), 8, 4, decoder="integrated")
        b = _program(cfg, 3.8, (5, 0), 8, 4, decoder="naive")
        gap = np.abs(np.log(a["tau_sqr"]) - np.log(b["tau_sqr"])).mean()
        assert (gap < 1e-5) == same, (logM, gap)
        if same:
            np.testing.assert_array_equal(a["errs"], b["errs"])
            np.testing.assert_array_equal(a["bp_iters"], b["bp_iters"])


# ---- spans and counters -------------------------------------------------------------

CALLER = "caller of concat_mc_counts"


@pytest.mark.parametrize("t_max", [3, 6])
def test_the_point_records_its_spans_and_counters(t_max):
    before = tracing.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            got = _program(_cfg(t_max=t_max), 3.8, (9, 0), 5, 2)
    after = tracing.counters()
    names = Counter(e.name for e in prof.events()
                    if e.name.startswith(("mc.", "concat.")))
    assert names == {"mc.designs": 1, "mc.bits": 1, "mc.encode": 1, "mc.noise": 1,
                     "mc.decode": 1, "mc.count": 1, "concat.amp": t_max,
                     "concat.eta": t_max - 1, "concat.bp_final": 1}
    mc = [e for e in prof.events() if e.name.startswith("mc.")]
    assert all(e.cpu_parent is not None and e.cpu_parent.name == CALLER for e in mc)
    assert after["concat.iters"] - before["concat.iters"] == t_max
    assert after["concat.decodes"] - before["concat.decodes"] == 1
    assert (after["concat.bp_codeword_iters"] - before["concat.bp_codeword_iters"]
            == got["bp_iters"].sum() > 0)


def test_spans_and_counters_change_no_output():
    quiet = _program(_cfg(), 3.5, (9, 1), 4, 2)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _program(_cfg(), 3.5, (9, 1), 4, 2)
    for key in ("errs", "bp_iters", "tau_sqr"):
        np.testing.assert_array_equal(quiet[key], traced[key])
