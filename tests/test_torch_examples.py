"""The port's example scripts (`ldpc_sparc_tpu_torch/examples/`), run
through their `main` on the CPU at their --small sizes: each writes its
JSON, and the numbers in it are what the port's entry points give for the
same seeds. The scripts import neither JAX nor the JAX package."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from ldpc_sparc_tpu_torch import DecodeParams, sparc_sim
from ldpc_sparc_tpu_torch.examples import concat_probes, sc_decode_wave, sparc_demo


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(module, tmp_path, *extra):
    out = tmp_path / "result.json"
    got = module.main(["--device", "cpu", "--small", "--json", str(out),
                       "--out", str(tmp_path / "figure.png"), *extra])
    assert json.loads(out.read_text()) == json.loads(json.dumps(got))
    return got


def test_sparc_demo_writes_the_four_families(tmp_path):
    got = _run(sparc_demo, tmp_path, "--runs", "1")
    assert got["device"] == "cpu" and got["runs_per_config"] == 1
    assert len(got["configs"]) == 4
    for name, p in sparc_demo.configs(True).items():
        st = got["configs"][name]
        r = sparc_sim(p, DecodeParams(t_max=got["t_max"]), 1.0, seed=0, device="cpu")
        assert st["ber"] == [float(r["ber"])] and st["t_final"] == [int(r["t_final"])]
        np.testing.assert_allclose(st["nmse"], r["nmse"].mean(-1).numpy(), rtol=1e-6)
        assert len(st["se_psi"]) == got["t_max"]


@pytest.mark.parametrize("fwht_mode", ["ms", "2mm_f32"])
def test_sc_decode_wave_writes_the_wave(tmp_path, fwht_mode):
    got = _run(sc_decode_wave, tmp_path, "--reps", "1", "--fwht-mode", fwht_mode)
    cfg = got["config"]
    assert (cfg["L"], cfg["M"], cfg["omega"], cfg["Lambda"]) == (256, 32, 3, 8)
    assert cfg["fwht_mode"] == fwht_mode
    wave = np.array(got["psi_wave"])
    assert wave.shape == (cfg["t_max"], 8) and np.isfinite(wave).all()
    # the wave: the boundary blocks settle before the middle ones
    t = int(np.argmax(wave.max(-1) < 0.5)) if (wave.max(-1) < 0.5).any() else 1
    assert wave[t // 2, [0, -1]].max() <= wave[t // 2, 3:5].min()
    assert len(got["wall_s_steady"]) == 1 and got["iterations"] > 0


def test_concat_probes_equal_decode_instrumented(tmp_path):
    """The script's probes are decode_instrumented's for trials 0 and 1,
    made here from ConcatCodec.encode(seed) and the (seed, CHANNEL)
    generator."""
    from ldpc_sparc_tpu_torch.models.sparc import awgn_channel
    from ldpc_sparc_tpu_torch.utils import rng as rngmod
    got = _run(concat_probes, tmp_path, "--seeds", "2", "--snr", "3.8")
    codec, dec = concat_probes.problem(True)
    assert got["config"]["user_bits"] == codec.user_bits_len
    awgn_var = codec.sparc.P / 3.8
    for decoder in concat_probes.DECODERS:
        pre, post = np.zeros(dec.t_max), np.zeros(dec.t_max)
        for seed in range(2):
            ub, _, _, x, design = codec.encode(seed, device="cpu")
            y = awgn_channel(x, awgn_var, rngmod.root_generator(
                rngmod.derive(seed, rngmod.CHANNEL), "cpu"))
            out = codec.decode_instrumented(y, design, dec, decoder)
            assert out["pre_bp"].shape == (dec.t_max, codec.user_bits_len)
            pre += (out["pre_bp"] != ub).double().mean(-1).numpy()
            post += (out["post_bp"] != ub).double().mean(-1).numpy()
        assert got["probes"][decoder]["pre_bp"] == (pre / 2).tolist()
        assert got["probes"][decoder]["post_bp"] == (post / 2).tolist()


# at most 0.1 % of a trial's user bits may be decided otherwise at any AMP
# iteration: two float32 FWHT chains round apart, and a bit on the edge
# flips (this trial: 1 bit of 7,200 at one of 25 iterations)
PROBE_BITS_DIFFER = 1e-3


@pytest.mark.parametrize("decoder", concat_probes.DECODERS)
def test_concat_probes_match_jax_at_z150(decoder):
    """At the script's full size, 802.16 r=1/2 z=150, mults 4, snr 3.8,
    t_max 25, the port's decode_instrumented gives the JAX package's probes
    on the JAX package's trial 1 (its design, user bits and y, as
    `examples/concat_probes.py` makes them): before and after BP at every
    AMP iteration, where BP corrects hundreds of bits and leaves 152 wrong."""
    import jax
    import jax.numpy as jnp
    from ldpc_sparc_tpu.config import DecodeParams as JDecode
    from ldpc_sparc_tpu.config import LdpcParams as JLdpc
    from ldpc_sparc_tpu.config import SparcParams as JParams
    from ldpc_sparc_tpu.config import param_calc
    from ldpc_sparc_tpu.models.concat import ConcatCodec as JCodec
    from ldpc_sparc_tpu.models.ldpc import get_code
    from ldpc_sparc_tpu.models.sparc import awgn_channel
    from ldpc_sparc_tpu.utils import rng as jrng
    from ldpc_sparc_tpu_torch.parity import design_from_jax_leaves

    codec, dec = concat_probes.problem(False)
    ldpc = JLdpc(standard="802.16", rate="1/2", z=150)
    _, _, L, lengths = param_calc(mults=4, logM=1, ldpc=ldpc, int_rate=ldpc.rate_float,
                                  R_sparc_ldpc=1.0, ldpc_K=get_code("802.16", "1/2", 150).K)
    jcodec = JCodec(JParams(P=19.44, R=1.0, L=L, M=2), ldpc, lengths, ldpc_protected=True)
    awgn_var = codec.sparc.P / 3.8
    key = jrng.root_key(1)
    jdesign = jcodec.build_design(1)
    ub, _, beta0 = jcodec.encode_message(key)
    y = awgn_channel(jdesign.ab(beta0 / jcodec.c_amp), jnp.float32(awgn_var),
                     jrng.derive(key, jrng.CHANNEL))
    want = jax.jit(lambda y: jcodec.decode_instrumented(
        y, jdesign, JDecode(t_max=dec.t_max), decoder))(y)
    got = codec.decode_instrumented(torch.as_tensor(np.array(y)),
                                    design_from_jax_leaves(*jdesign.tree_flatten()),
                                    dec, decoder)
    ub = np.asarray(ub)
    assert codec.user_bits_len == ub.size == 7200
    for probe in ("pre_bp", "post_bp"):
        w, g = np.asarray(want[probe]), got[probe].numpy()
        assert g.shape == w.shape == (dec.t_max, ub.size)
        assert (g != w).sum(-1).max() <= PROBE_BITS_DIFFER * ub.size, probe
    errs = {k: (got[k].numpy() != ub).sum(-1) for k in ("pre_bp", "post_bp")}
    assert errs["pre_bp"][-1] - errs["post_bp"][-1] > 500   # BP did the work
    assert 0 < errs["post_bp"][-1] < 0.1 * ub.size


def test_without_matplotlib_the_json_is_written(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = _run(sc_decode_wave, tmp_path)
    assert not (tmp_path / "figure.png").exists()
    assert "no figure written" in capsys.readouterr().err
    assert got["iterations"] > 0


def test_examples_import_no_jax():
    code = ("import sys\n"
            "import ldpc_sparc_tpu_torch.examples.sparc_demo\n"
            "import ldpc_sparc_tpu_torch.examples.sc_decode_wave\n"
            "import ldpc_sparc_tpu_torch.examples.concat_probes\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "       or m == 'ldpc_sparc_tpu' or m.startswith('ldpc_sparc_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
