"""The port's native C++ oracle and tools (native/) against the JAX
package's.

The port carries its own copies of the C++ sources; they must be
byte-identical to `ldpc_sparc_tpu/native/`'s, so both packages' oracles
are the same program and must agree exactly (app arrays bit for bit,
iteration counts equal) on the same float64 LLRs, for every decoder type.
The port's BP decode (plain, on the CPU) is held to the port's own oracle
on tests/test_ldpc.py's protocol (802.11n r=1/2 z=27, 2 dB, <= 60
iterations): iteration counts and decisions equal, the twin of
tests/test_torch_ldpc.py's check against the JAX package's oracle. The
native results2csv is byte-identical to the Python converter.
"""

import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

from ldpc_sparc_tpu.models import ldpc as jldpc
from ldpc_sparc_tpu.native import oracle as joracle
from ldpc_sparc_tpu.native import tools as jtools
from ldpc_sparc_tpu_torch.io import results as tresults
from ldpc_sparc_tpu_torch.models import ldpc as tldpc
from ldpc_sparc_tpu_torch.native import oracle, tools

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ["bp_ref.cpp", "bp_selftest.cpp", "bp_selftest_data.h", "results2csv.cpp"]
# tests/test_results.py's lines: the archived 10-field schema and the 9-field one
TXT_LINES = [
    "('802.16', '1/2', 3, 'A', -2.8277568533786299, 100, 100, 3600, 1675, 20000)",
    "('802.16', '3/4', 3, 'A', -0.66347569970478615, 100, 100, 5400, 1325, 20000)",
    "('802.16', '2/3', 3, 'A', -1.3103816364765377, 100, 100, 4800, 1439, 20000)",
    "('802.11n', '1/2', 27, 3.01, 128, 5, 41472, 57, 3200)",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (the suite runs files in parallel)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noisy_llrs(code, snr_db, n, seed):
    """(codewords, float64 LLRs) of n random codewords, BPSK over AWGN at
    sigma^2 = 10^(-snr_db/10), from numpy."""
    rng = np.random.default_rng(seed)
    x = code.encode(torch.as_tensor(rng.integers(0, 2, (n, code.K)))).numpy()
    sigma2 = 10 ** (-snr_db / 10)
    y = (1.0 - 2.0 * x) + rng.normal(0, np.sqrt(sigma2), x.shape)
    return x, 2.0 / sigma2 * y


@pytest.mark.parametrize("name", SOURCES)
def test_sources_are_byte_identical_copies(name):
    assert filecmp.cmp(ROOT / "ldpc_sparc_tpu_torch" / "native" / name,
                       ROOT / "ldpc_sparc_tpu" / "native" / name, shallow=False)


@pytest.mark.parametrize("dectype", ["sumprod", "sumprod2", "minsum"])
def test_oracle_decode_equals_the_jax_packages(dectype):
    code = tldpc.get_code("802.16", "1/2", 27)
    jcode = jldpc.get_code("802.16", "1/2", 27)
    _, llr = _noisy_llrs(code, 1.5, 4, seed=3)
    for row in llr:
        app, it = oracle.decode(row, code.vdeg, code.cdeg, code.intrlv, 50, dectype)
        japp, jit = joracle.decode(row, jcode.vdeg, jcode.cdeg, jcode.intrlv, 50,
                                   dectype)
        assert it == jit
        np.testing.assert_array_equal(app, japp)
        app2, it2 = code.decode_ref(row, 50, dectype)
        assert it2 == it
        np.testing.assert_array_equal(app2, app)


@pytest.mark.parametrize("dectype", ["sumprod", "sumprod2", "minsum"])
def test_port_decode_matches_its_own_oracle(dectype):
    """tests/test_ldpc.py's protocol against the port's oracle."""
    code = tldpc.get_code("802.11n", "1/2", 27)
    _, llr = _noisy_llrs(code, 2.0, 5, seed=0)
    res = code.decode(torch.as_tensor(llr, dtype=torch.float32), 60, dectype)
    for trial in range(5):
        app_ref, it_ref = code.decode_ref(llr[trial].astype(np.float32), 60, dectype)
        assert int(res.iterations[trial]) == it_ref, trial
        np.testing.assert_array_equal(res.app[trial].numpy() < 0, app_ref < 0)


@pytest.mark.parametrize("correct", [0, 1])
def test_lxor_lxfb_equal_the_jax_packages(correct):
    rng = np.random.default_rng(7 + correct)
    code = tldpc.get_code("802.11n", "1/2", 27)
    for a, b in rng.normal(0, 4, (5, 2)):
        assert oracle.lxor(a, b, correct) == joracle.lxor(a, b, correct)
        assert code.Lxor(a, b, correct) == oracle.lxor(a, b, correct)
    assert oracle.lxor(0.0, -2.0, correct) == joracle.lxor(0.0, -2.0, correct)
    L = rng.normal(0, 4, 7)
    total, ext = oracle.lxfb(L, correct)
    jtotal, jext = joracle.lxfb(L, correct)
    assert total == jtotal
    np.testing.assert_array_equal(ext, jext)
    ctotal, cext = code.Lxfb(L, correct)
    assert ctotal == total
    np.testing.assert_array_equal(cext, ext)


def test_bp_selftest_passes():
    out = tools.run_bp_selftest()
    assert out.strip().endswith("PASS")
    assert out.count(": ok") == 6


def test_results2csv_native_is_byte_identical(tmp_path):
    txt = tmp_path / "results.txt"
    txt.write_text("\n".join(TXT_LINES) + "\n")
    native = tools.results2csv_native(txt)
    assert native == tresults.results_txt_to_csv(txt)
    assert native == jtools.results2csv_native(txt)
    assert len(native.splitlines()) == 4
    out = tmp_path / "results.csv"
    assert tools.results2csv_native(txt, out) == native
    assert out.read_text() == native


def test_builds_land_in_the_ports_build_directory(tmp_path):
    """The oracle and tools build into the port's own `_build/`, named by
    a hash of their sources; a source that does not compile raises with
    the compiler's message."""
    build = ROOT / "ldpc_sparc_tpu_torch" / "_build"
    for path in (oracle.build(), tools.build_results2csv(), tools.build_bp_selftest()):
        assert path.parent == build and path.exists()
    bad = tmp_path / "bad.cpp"
    bad.write_text("int main( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        oracle.gxx_build("bad", [bad], ["-O0"])
