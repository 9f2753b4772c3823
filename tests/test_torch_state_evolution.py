"""The port's state evolution (models/state_evolution.py) against the JAX
package's, and the port's AMP decode against its own SE.

* `se_expectation` on the same numpy samples: within 1e-5 relative (float32
  exponentials, and sums taken in another order).
* `sparc_se`: the two packages draw their Monte-Carlo samples from other
  generators, so psi agrees within Monte-Carlo error. With 4000 samples
  each step's expectation has a standard error of at most 0.5 / sqrt(4000)
  = 0.008, and the error carries along the trajectory (the packages
  differed by at most 0.018 on these codes), so the bound is 0.05.
* AMP against SE, as tests/test_amp.py does: the mean NMSE of 8 decodes at
  L=256 tracks the SE trajectory within 0.08 over the first iterations.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ldpc_sparc_tpu.config import SparcParams as JParams
from ldpc_sparc_tpu.models import state_evolution as jse
from ldpc_sparc_tpu_torch import DecodeParams, SparcParams, sparc_se, sparc_sim
from ldpc_sparc_tpu_torch.models import state_evolution as tse

CODES = {
    "plain": dict(P=15.0, R=1.3, L=256, M=32),
    "plain-near-threshold": dict(P=15.0, R=1.6, L=256, M=32),
    "pa": dict(P=15.0, R=1.4, L=256, M=32, power_allocated=True, B=32,
               R_PA_ratio=1.0),
    "sc": dict(P=15.0, R=1.5, L=256, M=32, spatially_coupled=True, omega=3,
               Lambda=8),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (the suite runs files in parallel);
    float32 matmuls at full precision (no TF32)."""
    n, prec = torch.get_num_threads(), torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(n)
    torch.set_float32_matmul_precision(prec)
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("M", [2, 32, 512])
def test_se_expectation_matches_jax(M):
    u = np.random.default_rng(M).normal(size=(500, M)).astype(np.float32)
    tau = np.array([0.005, 0.02, 0.1, 0.3, 1.0, 3.0], np.float32)
    want = np.asarray(jse.se_expectation(jnp.asarray(tau), 1, jnp.asarray(u)))
    got = tse.se_expectation(torch.as_tensor(tau), 1, torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.all(np.isfinite(got)) and got[0] > 0.99


@pytest.mark.parametrize("name", sorted(CODES))
def test_sparc_se_matches_jax_within_monte_carlo_error(name):
    want, tau_j = jse.sparc_se(1.0, JParams(**CODES[name]), 25, 4000, seed=0)
    got, tau_t = sparc_se(1.0, SparcParams(**CODES[name]), 25, 4000, seed=0,
                          device="cpu")
    assert got.shape == want.shape and tau_t.shape == np.asarray(tau_j).shape
    assert np.all(got[0] == 1.0)
    assert np.abs(got - want).max() <= 0.05


def test_sparc_se_is_seeded_and_stops_early():
    a, _ = sparc_se(1.0, SparcParams(**CODES["plain"]), 25, 1000, seed=3,
                    device="cpu")
    b, _ = sparc_se(1.0, SparcParams(**CODES["plain"]), 25, 1000, seed=3,
                    device="cpu")
    np.testing.assert_array_equal(a, b)
    assert a[-1].max() < 1e-3                 # below threshold: psi -> 0
    near, _ = sparc_se(1.0, SparcParams(**CODES["plain-near-threshold"]), 25, 1000,
                       device="cpu")
    assert near[-1].min() > 0.3               # above the algorithmic threshold


def test_sparc_se_t_max_one_and_modulated():
    psi, tau = sparc_se(1.0, SparcParams(**CODES["plain"]), 1, 100, device="cpu")
    assert psi.shape == (1, 1) and tau.shape == (1,) and np.isfinite(tau).all()
    # modulated codes, once refused, run (held to JAX in test_torch_modulated.py)
    psi, tau = sparc_se(1.0, SparcParams(P=15.0, R=1.0, L=64, M=16, modulated=True,
                                         K=2), 10, 100, device="cpu")
    assert psi.shape == (10, 1) and psi[-1, 0] < 1e-3 and np.isfinite(tau).all()
    u = torch.complex(torch.ones(10, 4), torch.zeros(10, 4))
    e = tse.se_expectation(torch.ones(2), 4, u)
    assert e.shape == (2,) and bool(torch.isfinite(e).all())


def test_amp_matches_state_evolution():
    params = SparcParams(**CODES["plain"])
    psi_se, _ = sparc_se(1.0, params, 12, 4000, seed=0, device="cpu")
    nmse = np.mean([sparc_sim(params, DecodeParams(t_max=12), 1.0, seed=s,
                              device="cpu")["nmse"]
                    .numpy()[:, 0] for s in range(8)], axis=0)
    for t in range(1, 5):
        assert abs(nmse[t] - psi_se[t, 0]) < 0.08, (t, nmse[t], psi_se[t, 0])
