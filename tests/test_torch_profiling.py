"""The port's utils/profiling.py against the JAX package's.

The work models must give the JAX package's integers for the same
arguments (tests/test_profiling.py's shapes: the plain headline, a
non-power-of-two block, power allocation and spatial coupling with the
design's nonzero-block count), for both backends and the default and
explicit factor limits, and the width model must follow the port's design
engine. `timed` returns the function's result and a time; `trace` writes
a Chrome trace.
"""

import json

import numpy as np
import pytest
import torch

from ldpc_sparc_tpu.utils import profiling as jprof
from ldpc_sparc_tpu_torch import SparcDesign, SparcParams
from ldpc_sparc_tpu_torch.config import create_base_matrix
from ldpc_sparc_tpu_torch.utils import profiling as prof


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (the suite runs files in parallel)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape(kind):
    """(L, M, n, base_shape, n_blocks) of a plain, PA or SC configuration."""
    if kind == "plain":
        return 1024, 512, 9216, (1, 1), None
    if kind == "odd":
        return 1000, 32, 20000, (1, 1), None
    kw = (dict(power_allocated=True, B=16, R_PA_ratio=0.9) if kind == "pa"
          else dict(spatially_coupled=True, omega=2, Lambda=8))
    p = SparcParams(P=15.0, R=1.4, L=1024, M=32, **kw)
    W = create_base_matrix(p, 1.0)
    n = p.codeword_length()
    return p.L, p.M, n, W.shape, int((W != 0).sum())


@pytest.mark.parametrize("kind", ["plain", "odd", "pa", "sc"])
def test_fwht_width_follows_the_design_engine(kind):
    L, M, n, shape, _ = _shape(kind)
    W = np.ones(shape)
    d = SparcDesign.build(W, L, M, n, seed=0, device="cpu")
    assert prof.fwht_width(L, M, n, shape) == d.w == jprof.fwht_width(L, M, n, shape)


@pytest.mark.parametrize("kind", ["plain", "odd", "pa", "sc"])
@pytest.mark.parametrize("backend", ["xla", "pallas_ms"])
@pytest.mark.parametrize("mlf", [None, 5, 7, 10])
def test_amp_models_equal_the_jax_packages(kind, backend, mlf):
    L, M, n, shape, nb = _shape(kind)
    kw = dict(max_log_factor=mlf, backend=backend, base_shape=shape, n_blocks=nb)
    assert prof.amp_iteration_flops(L, M, n, **kw) == \
        jprof.amp_iteration_flops(L, M, n, **kw)
    assert prof.amp_iteration_hbm_bytes(L, M, n, **kw) == \
        jprof.amp_iteration_hbm_bytes(L, M, n, **kw)
    assert prof.amp_iteration_hbm_bytes(L, M, n, itemsize=2, **kw) == \
        jprof.amp_iteration_hbm_bytes(L, M, n, itemsize=2, **kw)


def test_hbm_bytes_fall_with_fewer_stages():
    assert prof.amp_iteration_hbm_bytes(1024, 512, 9216, max_log_factor=10) < \
        prof.amp_iteration_hbm_bytes(1024, 512, 9216, max_log_factor=5)


@pytest.mark.parametrize("E,z,dc,Mp", [(88, 27, 8, 12), (76, 150, 7, 12)])
def test_bp_iteration_flops_equal_the_jax_packages(E, z, dc, Mp):
    assert prof.bp_iteration_flops(E, z, dc, Mp) == jprof.bp_iteration_flops(E, z, dc, Mp) > 0


def test_timed_returns_the_result_and_a_time():
    calls = []

    def f(x):
        calls.append(1)
        return {"y": (x * 2.0,)}

    out, dt = prof.timed(f, torch.ones(8), reps=3, warmup=2)
    assert dt >= 0.0 and len(calls) == 5
    assert torch.equal(out["y"][0], torch.full((8,), 2.0))


def test_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "t.json"
    with prof.trace(str(path)):
        torch.ones(64).sum()
    assert "traceEvents" in json.loads(path.read_text())
