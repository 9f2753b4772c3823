"""The port's LDPC waterfall campaign (parallel/montecarlo.py).

Exact properties, at a tiny size on the CPU: the pipelined loop and the
serial loop give identical records, a run split in two by the resume
arguments gives the records of one full run, and the records keep the
reference's 10-field schema.

Against the JAX package the campaign can only agree statistically: the
port draws bits and noise from torch generators, the JAX package from
Threefry keys. At one fixed SNR both measure the block-error rate of
802.16 r=1/2 z=27 over 4096 blocks, and the two rates must differ by less
than the two-sided 99.9 % bound of a two-sample binomial test,
3.29 * sqrt(p (1 - p) (1/n1 + 1/n2)) with the pooled rate p. The seeds are
fixed, so the test is deterministic.
"""

import math

import pytest
import torch

from ldpc_sparc_tpu.config import LdpcParams as JLdpcParams
from ldpc_sparc_tpu.parallel.montecarlo import ldpc_waterfall_campaign as jcampaign
from ldpc_sparc_tpu_torch import LdpcParams, ldpc_waterfall_campaign


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs files in parallel processes: torch's intra-op thread
    pool in each of them oversubscribes the cores and slows these small
    tensors by 10x, so this file's torch work runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = dict(seed=0, n_measurements=4, min_errors=2, max_blocks=32, batch=8,
            dectype="sumprod2", max_iters=10, device="cpu")


@pytest.mark.parametrize("z,dectype", [(3, "sumprod2"), (6, "minsum")])
def test_pipelined_equals_serial(z, dectype):
    params = LdpcParams(standard="802.16", rate="1/2", z=z, ptype="A")
    kw = {**TINY, "dectype": dectype, "n_measurements": 3, "max_blocks": 64}
    piped = ldpc_waterfall_campaign(params, pipelined=True, **kw)
    serial = ldpc_waterfall_campaign(params, pipelined=False, **kw)
    assert piped == serial
    assert len(piped) == 3


@pytest.mark.parametrize("pipelined", [True, False])
def test_resume_exact(pipelined):
    params = LdpcParams(standard="802.16", rate="1/2", z=3, ptype="A")
    full = ldpc_waterfall_campaign(params, pipelined=pipelined, **TINY)
    assert len(full) == 4
    states = []
    part1 = ldpc_waterfall_campaign(
        params, pipelined=pipelined, **{**TINY, "n_measurements": 2},
        on_point=lambda rec, st: states.append(st))
    last = states[-1]
    part2 = ldpc_waterfall_campaign(
        params, pipelined=pipelined, **TINY, start_point=last["point"] + 1,
        start_snr=last["next_snr"], start_ctr=last["ctr"])
    assert part1 + part2 == full


def test_record_schema():
    params = LdpcParams(standard="802.16", rate="2/3", z=6, ptype="B")
    seen = []
    recs = ldpc_waterfall_campaign(params, **TINY, on_point=seen.append)
    assert seen == recs and len(recs) == 4
    K = 16 * 6
    for rec in recs:
        assert len(rec) == 10
        std, rate, z, ptype, snr, nblocks, nblk, nbits, nbit, nit = rec
        assert (std, rate, z, ptype) == ("802.16", "2/3", 6, "B")
        assert isinstance(snr, float)
        assert all(type(v) is int for v in rec[5:])
        assert nblocks % TINY["batch"] == 0 and nbits == nblocks * K
        assert 0 <= nblk <= nblocks and 0 <= nbit <= nbits
        assert 0 <= nit <= nblocks * TINY["max_iters"]
        assert nblk >= TINY["min_errors"] or nblocks >= TINY["max_blocks"]
    assert all(b[4] > a[4] for a, b in zip(recs, recs[1:]))  # SNR steps up


def test_block_error_rate_matches_jax():
    kw = dict(seed=3, n_measurements=1, min_errors=10 ** 9, max_blocks=4096,
              batch=256, dectype="sumprod2", max_iters=20, start_snr=1.5)
    (j,) = jcampaign(JLdpcParams(standard="802.16", rate="1/2", z=27), **kw)
    kw["device"] = "cpu"
    (t,) = ldpc_waterfall_campaign(LdpcParams(standard="802.16", rate="1/2",
                                              z=27), **kw)
    assert j[5] == t[5] == 4096 and j[7] == t[7]
    n = 4096
    p_j, p_t = j[6] / n, t[6] / n
    p = (j[6] + t[6]) / (2 * n)
    assert 0.05 < p < 0.95          # an SNR where the rate says something
    bound = 3.29 * math.sqrt(p * (1 - p) * 2 / n)
    assert abs(p_t - p_j) < bound, (p_t, p_j, bound)
