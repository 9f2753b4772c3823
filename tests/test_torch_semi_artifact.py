"""The port held to `docs/artifacts/concat_sweep_semi.jsonl`, the
semi-protected concatenated sweep (802.11n r=5/6 z=81, M=64, R_sparc 0.8,
mults 3: an unprotected prefix of sections beside the LDPC-protected rest).

On the CPU: the port's bookkeeping gives every one of the artifact's nine
meta records and its store keys; the hold's bound and the prefix-floor law
are checked on the artifact's own rows, each with a case that must fail.
The card runs `concat-sweep --semi-protected` at the three 25-run
configurations and holds its rows to the artifact's (chip_smoke.py).

The bound on |BER1 - BER2| (`artifacts.semi_bounds`) is the larger of a bit
term, Z_999 sqrt(logM (p1 (1 - p1) / bits1 + p2 (1 - p2) / bits2)), a
section error flipping up to logM = 6 bits, and a frame term from the two
rows' spreads, Z_999 sqrt(((max1 - min1) / 2)^2 / frames1 + ((max2 - min2) /
2)^2 / frames2). At the floor (linear SNR 6.0) the sequential decoder's
bound must stay within 0.012, half the smallest gap between neighbouring
floors (0.0047 / 0.0289 / 0.0539 at percent_protected 0.9 / 0.8 / 0.7).
"""

import argparse
import json

import pytest
import torch

from ldpc_sparc_tpu_torch import LdpcParams, artifacts, cli, get_code, param_calc_semi_protected

LOGM = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _metas():
    lines = (artifacts.ARTIFACTS / artifacts.SEMI_ARTIFACT).read_text().splitlines()
    return [r for r in map(json.loads, lines) if "config" in r]


@pytest.mark.parametrize("meta", _metas(), ids=lambda m: m["key"])
def test_bookkeeping_gives_every_meta_record(meta):
    """param_calc_semi_protected: lengths, L_sparc, L_sparc_ldpc and the
    overall rate of each of the nine configurations, and the CLI's meta
    record. The store key is the CLI's: the 25-run configurations carry the
    current key (store_version 2, rows keyed by linear SNR), the earlier
    ones the key before that version was added."""
    c = meta["config"]
    ldpc = LdpcParams(standard=c["standard"], rate=c["rate"], z=c["z"])
    L_sparc, R_ldpc, L_ldpc, lengths, rate = param_calc_semi_protected(
        c["R_sparc"], c["mults"], c["percent_protected"], 2 ** c["logM"], ldpc,
        ldpc.rate_float, get_code(c["standard"], c["rate"], c["z"]).K)
    assert (L_sparc, L_ldpc, rate) == (c["L_sparc"], c["L_sparc_ldpc"], c["overall_rate"])
    assert {"k_ldpc": lengths.k_ldpc, "mults": lengths.mults,
            "L_unprotected": lengths.L_unprotected} == c["lengths"]
    ns = argparse.Namespace(**{k: c[k] for k in ("standard", "rate", "z", "P", "mults",
                                                 "logM", "R_sparc", "t_max", "runs")},
                            semi_protected=True, percent_protected=c["percent_protected"])
    ldpc, sp_plain, sp_ldpc, lengths, rate, L_sparc = cli.concat_setup(ns)
    assert cli.concat_meta(ns, rate, L_sparc, sp_ldpc, lengths) == {"config": c}
    key = (cli.concat_config_key(ns, ldpc, sp_plain, sp_ldpc, lengths) if c["runs"] == 25
           else cli._config_key(ldpc=ldpc, sp_plain=sp_plain, sp_ldpc=sp_ldpc,
                                lengths=lengths, t_max=c["t_max"], runs=c["runs"],
                                semi=True))
    assert f"meta:{key}" == meta["key"]


def test_semi_configs_and_the_held_rows():
    cfgs = artifacts.semi_configs()
    assert sorted(cfgs) == sorted(artifacts.SEMI_PROTECTED)
    for pp, (cfg, h, rows) in cfgs.items():
        assert cfg["runs"] == 25 and cfg["logM"] == LOGM and len(rows) == 30
        for snr, decoders in artifacts.SEMI_DECODERS.items():
            for d in decoders:
                r = rows[artifacts.semi_row_key(h, d, snr)]
                assert r["decoder"] == d and r["frames"] == 25
                assert r["bits"] == 25 * (cfg["lengths"]["k_ldpc"]
                                          + LOGM * cfg["lengths"]["L_unprotected"])
                assert r["ber_min"] <= r["ber"] <= r["ber_max"]


def test_the_cli_arguments_key_the_artifacts_rows(tmp_path, monkeypatch):
    """run_semi_rows' two concat-sweep calls store exactly the held rows,
    under the artifact's keys (the decode is stubbed here)."""
    from ldpc_sparc_tpu_torch.parallel import montecarlo as tmc
    calls = []

    def stub(sp, ldpc, lengths, protected, decode, awgn_var, seed, n_trials, decoder,
             device=None):
        calls.append((decoder, round(sp.P / awgn_var, 6), n_trials, seed, protected))
        return {"ber": 0.1, "ber_min": 0.0, "ber_max": 0.2, "frame_errs": 1,
                "frames": n_trials, "bit_errs": 1, "bits": 10}

    monkeypatch.setattr(tmc, "concat_ber_point", stub)
    for pp, (cfg, h, rows) in artifacts.semi_configs().items():
        calls.clear()
        got = artifacts.run_semi_rows(pp, tmp_path / str(pp), device="cpu")
        want = {artifacts.semi_row_key(h, d, snr)
                for snr, ds in artifacts.SEMI_DECODERS.items() for d in ds}
        assert set(got) == want | {f"meta:{h}"} and want <= set(rows)
        assert got[f"meta:{h}"]["config"] == cfg
        assert sorted(calls) == sorted(
            (d, round(snr, 6), 25, (0, 0), d != "amp_only")
            for snr, ds in artifacts.SEMI_DECODERS.items() for d in ds)


def _held(pp, decoder, snr):
    _, h, rows = artifacts.semi_configs()[pp]
    return rows[artifacts.semi_row_key(h, decoder, snr)]


@pytest.mark.parametrize("pp", artifacts.SEMI_PROTECTED)
def test_bound_on_the_artifacts_rows(pp):
    """Each held row passes against itself with both terms stated; at the
    floor the sequential decoder's bound is within 0.012, and a row moved by
    the gap to the neighbouring floor fails."""
    floor = artifacts.SEMI_SNRS[1]
    for snr, decoders in artifacts.SEMI_DECODERS.items():
        for d in decoders:
            r = _held(pp, d, snr)
            got = artifacts.compare_semi_row(r, r, LOGM)
            assert got["ok"] and got["bound"] == max(got["bit_bound"], got["frame_bound"])
            assert got["bit_bound"] > 0 and got["frame_bound"] > 0
    seq = _held(pp, "sequential", floor)
    bound = artifacts.compare_semi_row(seq, seq, LOGM)["bound"]
    assert bound <= artifacts.SEMI_FLOOR_BOUND
    for shift in (-0.0242, 0.0242):
        moved = dict(seq, ber=seq["ber"] + shift)
        if 0 < moved["ber"] < 1:
            assert not artifacts.compare_semi_row(moved, seq, LOGM)["ok"]


def test_neighbouring_floors_are_told_apart():
    """0.9's sequential floor held against 0.8's, and 0.8's against 0.7's,
    must fail: the bound at the floor separates the configurations."""
    floor = artifacts.SEMI_SNRS[1]
    f = {pp: _held(pp, "sequential", floor) for pp in artifacts.SEMI_PROTECTED}
    assert not artifacts.compare_semi_row(f[0.9], f[0.8], LOGM)["ok"]
    assert not artifacts.compare_semi_row(f[0.8], f[0.7], LOGM)["ok"]


def test_prefix_floor_law_on_the_artifacts_rows():
    """The law tests/test_sweep_artifacts.py gates the artifact on: the
    sequential floor at SNR 6.0 rises strictly 0.9 -> 0.8 -> 0.7, naive's
    stays above 0.1; swapped floors or a low naive floor break it."""
    floor = artifacts.SEMI_SNRS[1]
    floors = {pp: {d: _held(pp, d, floor)["ber"] for d in ("sequential", "naive")}
              for pp in artifacts.SEMI_PROTECTED}
    assert artifacts.semi_floor_law(floors) == []
    assert [round(floors[pp]["sequential"], 4) for pp in (0.9, 0.8, 0.7)] == [
        0.0047, 0.0289, 0.0539]
    swapped = {0.9: floors[0.8], 0.8: floors[0.9], 0.7: floors[0.7]}
    assert len(artifacts.semi_floor_law(swapped)) == 1
    low = {**floors, 0.7: dict(floors[0.7], naive=0.05)}
    assert artifacts.semi_floor_law(low) == ["naive floor 0.05 <= 0.1 at 0.7"]
