"""A run with the timed path broken underneath comes out not correct.

Each test drives `run_cell` (the harness without its look for a card) on
the CPU at a small size of each cell, with the cell's own limits, and
breaks the program where it produces: an AMP step that returns its state
unchanged, half of each batch left out (the rest counted twice), and an
answer altered where the decode produces it. A sound run is correct. (One
chip: no exchange between chips to leave out.)"""

import pytest
import torch

import ldpc_sparc_tpu_torch.models.sparc as sparc_mod
import ldpc_sparc_tpu_torch.parallel.montecarlo as mc
from perfbench.run import run_cell

SMALL = {
    "sparc_flagship.deep_6db": ({"L": 64, "M": 64, "t_max": 14},
                                {"trials_per_point": 16, "designs": 4, "snr": [4.0]}),
    "sparc_sc_large.wave_snr15": ({"L": 64, "M": 64, "omega": 2, "Lambda": 8, "t_max": 18},
                                  {"trials_per_point": 16, "designs": 4, "snr": [5.0]}),
}
CELLS = sorted(SMALL)


def run_small(cell, seed=2**31 + 77):
    config, traffic = SMALL[cell]
    result, _ = run_cell(cell, seed, 0.2, False, device="cpu",
                         driver_kw={"config_update": config, "traffic_update": traffic})
    return result


def stuck_step(beta, azo, tau_sec, M):
    """A denoiser step that hands back the state it was given."""
    return beta, beta.clone(), (beta.reshape(*tau_sec.shape, M) ** 2).sum(-1)


def half_batch(decode):
    def run(y, *a, **k):
        h = (y.shape[0] + 1) // 2
        beta, t = decode(y[:h], *a, **k)
        return torch.cat([beta, beta])[:y.shape[0]], torch.cat([t, t])[:y.shape[0]]
    return run


def altered_answer(decode):
    def run(y, design, params, *a, **k):
        beta, t = decode(y, design, params, *a, **k)
        beta = beta.clone()
        beta[:, :params.M] = beta[:, :params.M].roll(1, dims=-1)
        return beta, t
    return run


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = run_small(cell)
    assert result["correct"], result["check"]
    rate = "mc_trials_per_s.sc" if "sc_large" in cell else "mc_trials_per_s"
    assert set(result["metrics"]) == {rate, "setup_s"}   # no memory peak on a CPU
    assert list(result)[-1] == "check"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["stuck_step", "half_batch", "altered_answer"])
def test_broken_run_is_not_correct(cell, fault, monkeypatch):
    if fault == "stuck_step":
        monkeypatch.setattr(sparc_mod, "fused_denoise_update", stuck_step)
    else:
        wrap = {"half_batch": half_batch, "altered_answer": altered_answer}[fault]
        monkeypatch.setattr(mc, "decode_batch", wrap(mc.decode_batch))
    result = run_small(cell)
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("name", ["jax", "jaxlib.xla_client", "flax", "ldpc_sparc_tpu.ops"])
def test_a_run_that_loaded_jax_reports_nothing(name, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, name, type(pytest)(name))
    with pytest.raises(SystemExit, match=name.split(".")[0]):
        run_small(CELLS[0])
