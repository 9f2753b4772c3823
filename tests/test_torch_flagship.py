"""The port's plain path against the JAX package at two full shapes, on the
CPU, through the fixture of tests/data/ (written by
tests/data/make_flagship_fixture.py: 4 codewords each, y and the JAX
package's decisions). The card tests of tests/test_torch_kernels.py decode
the same y through K1+K3 and K1+K4; here the plain versions run, so the
chain JAX -> plain path -> kernels closes at these shapes. Both draws
converge, so the decisions must be equal; t_final is equal under the plain
denoiser tail. The first test runs the fixture's script in memory, with the
JAX package as it is now, and holds the committed files to what it returns:
a stale fixture fails there. torch runs on one thread, float32 matmuls at
full precision.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from ldpc_sparc_tpu_torch import (ConcatCodec, DecodeParams, LdpcParams, SparcDesign,
                                  SparcParams, get_code, param_calc)
from ldpc_sparc_tpu_torch.models import sparc

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)


@pytest.fixture(scope="module")
def meta():
    return json.loads((DATA / "flagship.json").read_text())


def _load(name):
    return np.load(DATA / f"flagship_{name}.npy")


@pytest.mark.parametrize("which", ["amp", "concat"])
def test_committed_fixture_is_what_the_jax_package_writes_now(meta, which):
    spec = importlib.util.spec_from_file_location("make_flagship_fixture",
                                                  DATA / "make_flagship_fixture.py")
    maker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maker)
    assert maker.N_CODEWORDS == meta["n_codewords"]
    record, arrays = maker.MAKERS[which]()
    assert json.loads(json.dumps(record)) == meta[which]
    assert len(arrays) >= 2
    for stem, a in arrays.items():
        stored = np.load(DATA / f"{stem}.npy")
        assert stored.dtype == a.dtype
        np.testing.assert_array_equal(stored, a, err_msg=stem)


def test_fixture_is_what_its_script_describes(meta):
    B = meta["n_codewords"]
    a, c = meta["amp"], meta["concat"]
    assert _load("amp_y").shape == (B, a["n"]) and _load("amp_y").dtype == np.float32
    assert _load("amp_sections").shape == (B, a["L"])
    assert _load("concat_y").shape == (B, c["n"])
    assert _load("concat_user_bits").shape == (B, c["user_bits_len"] // 8)
    assert len(a["t_final"]) == len(c["errors"]) == B
    assert a["section_errors"] == [0] * B and c["errors"] == [0] * B   # both converge


def test_amp_headline_plain_path_matches_the_jax_fixture(meta):
    c = meta["amp"]
    params = SparcParams(P=c["P"], R=c["R"], L=c["L"], M=c["M"])
    design = SparcDesign.for_params(params, c["awgn_var"], c["design_seed"], device="cpu")
    beta, t_final = sparc.decode_batch(torch.as_tensor(_load("amp_y")), design, params,
                                       DecodeParams(t_max=c["t_max"]), c["awgn_var"],
                                       fused_denoiser=False)
    sections = beta.reshape(-1, c["L"], c["M"]).argmax(-1)
    np.testing.assert_array_equal(sections.numpy(), _load("amp_sections"))
    assert t_final.tolist() == c["t_final"]


def test_concat_z150_plain_path_matches_the_jax_fixture(meta):
    c, B = meta["concat"], meta["n_codewords"]
    ldpc = LdpcParams(c["standard"], c["rate"], c["z"])
    _, _, L, lengths = param_calc(c["mults"], c["logM"], ldpc, ldpc.rate_float,
                                  c["R_sparc"], get_code(c["standard"], c["rate"], c["z"]).K)
    codec = ConcatCodec(SparcParams(P=c["P"], R=c["R_sparc"], L=L, M=2 ** c["logM"]),
                        ldpc, lengths, True)
    assert (L, codec.n, codec.user_bits_len) == (c["L"], c["n"], c["user_bits_len"])
    designs = codec.build_designs(tuple(c["seed"]), B, "cpu")
    assert (designs.w, designs.offset) == (1 << 15, 1)
    got = codec.decode_batch(torch.as_tensor(_load("concat_y")), designs,
                             DecodeParams(t_max=c["t_max"]), c["decoder"]).numpy()
    unpack = lambda k: np.unpackbits(_load(k), axis=-1)[:, :codec.user_bits_len]
    np.testing.assert_array_equal(got, unpack("concat_bits_out"))
    assert (got != unpack("concat_user_bits")).sum(-1).tolist() == c["errors"]
