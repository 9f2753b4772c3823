"""The port's mesh (parallel/mesh.py, parallel/sharded.py and the `mesh=`
argument of parallel/montecarlo.py) on gloo ranks spawned on the CPU.

The bar is tests/test_parallel.py's: counters EXACTLY independent of the
partition and equal to `mesh=None` (per-trial error arrays for the
concatenated path, records for the campaign); `ShardedDesign`'s leaves
bit-identical to the JAX package's for the same seed, its operator the
unsharded design's as a dense matrix; the section-sharded step's counters
equal across (1,4), (4,1) and (2,2) (and (2,1), (1,2)); its `decode(y)`
equal to the unsharded `decode_batch` on equal y, decisions and t_final,
on the codewords where the unsharded decode converges. Two spawns (a world
of four and one of two ranks, one torch thread each) run every mesh
scenario once; the tests read their results. At (1,1), on a world of one
in this process, the step decodes through `amp_decode` exactly as
`decode_batch` does: every row's decisions and t_final equal, the rows at
the cap included, for the plain, tall, power-allocated, SC, complex K=4
and real K=2 codes under both phi_est_methods. This module imports no JAX
at the top, since the ranks import it.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from ldpc_sparc_tpu_torch import (DecodeParams, LdpcParams, SparcDesign, SparcParams,
                                  get_code, param_calc)
from ldpc_sparc_tpu_torch.models.sparc import awgn_channel, decode_batch
from ldpc_sparc_tpu_torch.parallel import montecarlo as tmc
from ldpc_sparc_tpu_torch.parallel.mesh import make_mesh, run_ranks
from ldpc_sparc_tpu_torch.parallel.sharded import ShardedDesign, make_sharded_sim_step
from ldpc_sparc_tpu_torch.utils import bits as bitops

MC = dict(params=SparcParams(P=15.0, R=1.6, L=64, M=16), decode=DecodeParams(t_max=10),
          awgn_var=2.0, seed=3)
DFT = dict(params=SparcParams(P=15.0, R=2.6, L=256, M=8, modulated=True, K=4,
                              is_complex=True),
           decode=DecodeParams(t_max=14), awgn_var=1.0, seed=4, engine="dft")
SC = SparcParams(P=15.0, R=1.4, L=64, M=16, spatially_coupled=True, omega=2, Lambda=8)
SC_CONV = SparcParams(P=15.0, R=1.2, L=64, M=16, spatially_coupled=True, omega=2,
                      Lambda=8)
MOD = SparcParams(P=15.0, R=1.0, L=64, M=16, modulated=True, K=4, is_complex=True,
                  spatially_coupled=True, omega=2, Lambda=8)
TALL = SparcParams(P=12.0, R=0.3, L=32, M=8)
CAMPAIGN = dict(seed=0, n_measurements=3, min_errors=4, max_blocks=64, batch=16,
                max_iters=30)
LDPC = LdpcParams(standard="802.11n", rate="1/2", z=27)


def _concat():
    ldpc = LdpcParams(standard="802.16", rate="1/2", z=12)
    _, _, L, lengths = param_calc(2, 2, ldpc, 0.5, 1.0, get_code("802.16", "1/2", 12).K)
    return (SparcParams(P=19.44, R=1.0, L=L, M=4), ldpc, lengths, True,
            DecodeParams(t_max=8), 19.44 / 6.0, 2, 6)


def _sharded(params, mesh, seeds, seed, t_max=8, y=None):
    step, _ = make_sharded_sim_step(params, DecodeParams(t_max=t_max), 1.0, mesh,
                                    seed=seed)
    return step(seeds) if y is None else step.decode(y)


def _world4(y_conv):
    """Every four-rank scenario; each rank returns the same dict."""
    m41, m22, m14 = (make_mesh(dp, sec, device="cpu") for dp, sec in
                     ((4, 1), (2, 2), (1, 4)))
    code = get_code(LDPC.standard, LDPC.rate, LDPC.z)
    out = {
        "mc": [tmc.sparc_mc_counts(n_trials=16, mesh=m, **MC) for m in (m41, m22)],
        "mc_pad": tmc.sparc_mc_counts(n_trials=6, mesh=m41, **MC),
        "dft": tmc.sparc_mc_counts(n_trials=8, mesh=m41, **DFT),
        "concat": tmc.concat_mc_trial_errors(*_concat(), decoder="naive", mesh=m41),
        "concat_point": tmc.concat_ber_point(*_concat(), decoder="naive", mesh=m41),
        "concat_counts": tmc.concat_mc_counts(*_concat(), decoder="integrated", mesh=m41),
        "blocks": [tmc._ldpc_block_counts(code, 3.0, 0, 0, b, 60, "sumprod2", mesh=m)
                   for m in (m41, m22) for b in (16, 18)],
        "campaign": [tmc.ldpc_waterfall_campaign(LDPC, mesh=m, **CAMPAIGN)
                     for m in (m41, m22)],
        "sharded": [_sharded(SC, m, list(range(4)), 5) for m in (m14, m41, m22)],
        "sharded_pad": _sharded(SC, m41, list(range(3)), 5),
        "mod": _sharded(MOD, m14, [(4, t) for t in range(4)], 1),
        "decode": [_sharded(SC_CONV, m, None, 3, 20, y_conv) for m in (m22, m14)],
    }
    return out


def _world2():
    m21, m12 = make_mesh(2, 1, device="cpu"), make_mesh(1, 2, device="cpu")
    return {"mc": tmc.sparc_mc_counts(n_trials=16, mesh=m21, **MC),
            "sharded": _sharded(SC, m12, list(range(4)), 5),
            "mod": _sharded(MOD, m21, [(4, t) for t in range(4)], 1),
            "tall": _sharded(TALL, m21, [(2, t) for t in range(4)], 0)}


def _conv_words():
    """(y, unsharded decisions, unsharded t_final) of 6 words of SC_CONV."""
    d = SparcDesign.for_params(SC_CONV, 1.0, 3, device="cpu")
    gen = torch.Generator().manual_seed(11)
    bits = torch.randint(0, 2, (6, SC_CONV.bit_len), generator=gen).bool()
    y = d.ab(bitops.bits_to_msg_vector(bits, SC_CONV.M)) + torch.randn(6, d.n, generator=gen)
    beta, t = decode_batch(y, d, SC_CONV, DecodeParams(t_max=20), 1.0)
    return y, beta, t


@pytest.fixture(scope="module")
def world4():
    y, beta, t = _conv_words()
    outs = run_ranks(_world4, 4, y, timeout=400)
    for o in outs[1:]:
        for k in ("mc", "mc_pad", "dft", "blocks", "campaign", "sharded", "mod"):
            assert o[k] == outs[0][k], k
        np.testing.assert_array_equal(o["concat"], outs[0]["concat"])
        for k in ("errs", "bp_iters", "tau_sqr"):
            np.testing.assert_array_equal(o["concat_counts"][k], outs[0]["concat_counts"][k])
    return {**outs[0], "conv": (y, beta, t)}


@pytest.fixture(scope="module")
def world2():
    outs = run_ranks(_world2, 2, timeout=300)
    assert outs[0] == outs[1]
    return outs[0]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sparc_mc_partition_invariance(world4, world2):
    want = tmc.sparc_mc_counts(n_trials=16, device="cpu", **MC)
    assert world4["mc"] == [want, want] and world2["mc"] == want
    assert want["frames"] == 16 and 0 < want["bit_errs"] <= want["bits"]


def test_sparc_mc_padding_non_divisible(world4):
    want = tmc.sparc_mc_counts(n_trials=6, device="cpu", **MC)
    assert world4["mc_pad"] == want and want["frames"] == 6


def test_sparc_mc_dft_engine(world4):
    want = tmc.sparc_mc_counts(n_trials=8, device="cpu", **DFT)
    assert world4["dft"] == want
    assert want["bit_errs"] == 0 and "loc_errs" in want


def test_concat_mc_per_trial_errors(world4):
    want = tmc.concat_mc_trial_errors(*_concat(), decoder="naive", device="cpu")
    assert world4["concat"].shape == (6,)
    np.testing.assert_array_equal(world4["concat"], want)
    pt = world4["concat_point"]
    assert pt == tmc.concat_ber_point(*_concat(), decoder="naive", device="cpu")
    assert pt["bit_errs"] == int(want.sum()) and pt["frames"] == 6


def test_concat_mc_counts_over_the_mesh(world4):
    """Each trial's errors, BP iterations and tau^2 trajectory come back on
    every rank, summed over 'dp', equal to one process's."""
    want = tmc.concat_mc_counts(*_concat(), decoder="integrated", device="cpu")
    got = world4["concat_counts"]
    assert got.keys() == want.keys() and got["frames"] == 6
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
    assert got["tau_sqr"].shape == (6, 8) and (got["tau_sqr"] > 0).all()


def test_ldpc_block_counts_and_campaign(world4):
    code = get_code(LDPC.standard, LDPC.rate, LDPC.z)
    want = [tmc._ldpc_block_counts(code, 3.0, 0, 0, b, 60, "sumprod2", device="cpu")
            for b in (16, 18)]
    assert world4["blocks"] == want * 2
    assert want[0][1] <= 2          # 3 dB is past the waterfall of rate 1/2
    piped = tmc.ldpc_waterfall_campaign(LDPC, device="cpu", **CAMPAIGN)
    assert world4["campaign"] == [piped, piped] and len(piped) == 3


def test_sharded_design_leaves_equal_the_jax_packages():
    from ldpc_sparc_tpu.parallel.sharded import ShardedDesign as JShardedDesign
    from ldpc_sparc_tpu.config import SparcParams as JParams
    for p, seed in ((SparcParams(P=15.0, R=1.0, L=64, M=16), 7),
                    (SparcParams(P=15.0, R=1.4, L=32, M=8, spatially_coupled=True,
                                 omega=2, Lambda=8), 3), (TALL, 0)):
        sd = ShardedDesign(p, 1.0, seed, device="cpu")
        jd = JShardedDesign(JParams(**{f: getattr(p, f) for f in p.__dataclass_fields__}),
                            1.0, seed)
        for name in ("idx", "signs", "scale"):
            np.testing.assert_array_equal(getattr(sd, name).numpy(),
                                          np.asarray(getattr(jd, name)))
        for name in ("rows", "cols"):
            np.testing.assert_array_equal(getattr(sd, name), np.asarray(getattr(jd, name)))
        assert (sd.w, sd.design.offset, sd.blocks_per_col) == \
            (jd.w, jd.design.offset, jd.blocks_per_col)


def test_sharded_design_is_the_unsharded_operator():
    p = SparcParams(P=15.0, R=1.4, L=32, M=8, spatially_coupled=True, omega=2, Lambda=8)
    sd = ShardedDesign(p, 1.0, 3, device="cpu")
    ud = SparcDesign.for_params(p, 1.0, 3, device="cpu")
    whole = sd.design.with_leaves(sd.idx, sd.signs, sd.scale,
                                  rows=tuple(int(r) for r in sd.rows),
                                  cols=tuple(int(c) for c in sd.cols))
    np.testing.assert_array_equal(whole.dense(), ud.dense())
    for n in (2, 4):
        shards = [sd.shard(i, n) for i in range(n)]
        assert all((s.w, s.offset, s.tall, s.Lc) == (ud.w, ud.offset, ud.tall, ud.Lc // n)
                   for s in shards)
        np.testing.assert_array_equal(np.hstack([s.dense() for s in shards]), ud.dense())


def test_sharded_step_partition_invariance(world4, world2):
    (a, b, c), d = world4["sharded"], world2["sharded"]
    assert a == b == c == d, (a, b, c, d)
    assert 0 < a["iter_sum"] <= 4 * 8
    pad = world4["sharded_pad"]
    assert pad["iter_sum"] <= a["iter_sum"] and pad["bit_errs"] <= a["bit_errs"]


def test_sharded_modulated_complex(world4, world2):
    assert world4["mod"] == world2["mod"], (world4["mod"], world2["mod"])
    assert world4["mod"]["frame_errs"] <= 1


def test_sharded_tall_blocks(world2):
    assert world2["tall"]["bit_errs"] == 0 and world2["tall"]["frame_errs"] == 0


def test_sharded_decode_matches_unsharded_decode_batch(world4):
    y, beta, t = world4["conv"]
    converged = t < 19
    assert int(converged.sum()) >= 4
    for got_beta, got_t in world4["decode"]:
        assert torch.equal(got_t[converged], t[converged])
        assert torch.equal(got_beta[converged], beta[converged])


def test_world_of_one_needs_no_launcher():
    import torch.distributed as dist
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(device="cpu")
        assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("dp", "sec")
        assert tmc.sparc_mc_counts(n_trials=6, mesh=mesh, **MC) == \
            tmc.sparc_mc_counts(n_trials=6, device="cpu", **MC)
        y, beta, t = _conv_words()
        got_beta, got_t = _sharded(SC_CONV, mesh, None, 3, 20, y)
        assert torch.equal(got_beta, beta) and torch.equal(got_t, t)
        # fwht_mode="2mm": K2's plain version on the 2^14 offset-0 windows
        p = SparcParams(P=15.0, R=1.0, L=64, M=2048, spatially_coupled=True, omega=2,
                        Lambda=8)
        d = SparcDesign.for_params(p, 1.0, 3, device="cpu")
        assert (d.w, d.offset) == (1 << 14, 0)
        gen = torch.Generator().manual_seed(0)
        bits = torch.randint(0, 2, (2, p.bit_len), generator=gen).bool()
        y = d.ab(bitops.bits_to_msg_vector(bits, p.M)) + torch.randn(2, d.n, generator=gen)
        want = decode_batch(y, d, p, DecodeParams(t_max=10), 1.0, fwht_mode="2mm")
        step, _ = make_sharded_sim_step(p, DecodeParams(t_max=10), 1.0, mesh, seed=3,
                                        fwht_mode="2mm")
        got = step.decode(y)
        assert torch.equal(got[1], want[1]) and int((want[1] < 9).sum()) >= 1
        assert torch.equal(got[0], want[0])
        with pytest.raises(ValueError, match="needs 2 ranks"):
            make_mesh(dp=2, device="cpu")
    finally:
        dist.destroy_process_group()


def test_launcher_two_processes():
    out = subprocess.run([sys.executable, "-m", "ldpc_sparc_tpu_torch.parallel.multiproc_mc",
                          "--nprocs", "2", "--device", "cpu"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert out.stdout.strip().endswith("multi-process run OK")
    assert '"processes": 2' in out.stdout


# the families the sharded step at (1,1) is held to `decode_batch` on, each
# with the t_max at which its noise ladder leaves rows both stopped and at
# the cap
PA = SparcParams(P=15.0, R=1.6, L=64, M=16, power_allocated=True, B=16, R_PA_ratio=0.9)
REAL_K2 = dataclasses.replace(SC, modulated=True, K=2)
ONE = {"plain": (MC["params"], 30), "tall": (TALL, 20), "pa": (PA, 30), "sc": (SC, 30),
       "sc_conv": (SC_CONV, 30), "mod": (MOD, 30), "real_k2": (REAL_K2, 30)}
NOISE = torch.tensor([1.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0, 4.0, 5.0, 6.0, 8.0, 12.0])


@pytest.fixture(scope="module")
def mesh11():
    """A world of one in this process, kept to the module's end: the tests
    that take it come after `test_world_of_one_needs_no_launcher`, which
    needs no group to exist."""
    import torch.distributed as dist
    mesh = make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("phi_est_method", (1, 2))
@pytest.mark.parametrize("family", sorted(ONE))
def test_world_of_one_step_decodes_as_decode_batch(mesh11, family, phi_est_method):
    """At (1,1) the sharded step runs `amp_decode` on the whole design in
    column-major block order: every row's decisions and t_final equal the
    unsharded decode's, the rows that stop at the cap included."""
    p, t_max = ONE[family]
    dec = DecodeParams(t_max=t_max, phi_est_method=phi_est_method)
    d = SparcDesign.for_params(p, 1.0, 3, device="cpu")
    gen = torch.Generator().manual_seed(11)
    bits = torch.randint(0, 2, (len(NOISE), p.bit_len), generator=gen).bool()
    x = d.ab(bitops.bits_to_msg_vector(bits, p.M, p.K))
    y = x + awgn_channel(torch.zeros_like(x), 1.0, gen) * NOISE[:, None]
    beta, t = decode_batch(y, d, p, dec, 1.0)
    assert 0 < int((t < t_max - 1).sum()) < len(NOISE), t
    step, _ = make_sharded_sim_step(p, dec, 1.0, mesh11, seed=3)
    got_beta, got_t = step.decode(y)
    assert torch.equal(got_t, t), (got_t, t)
    assert got_beta.dtype == beta.dtype and torch.equal(got_beta, beta)
