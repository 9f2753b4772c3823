"""The port's `ldpc-campaign`, `results2csv`, `plot-results` and the
figures (cli.py, io/results.py) against the JAX CLI.

Exact properties, at a tiny size on the CPU: the grid-engine table and
the campaign store's configuration key are the JAX CLI's; a campaign
killed after point k and rerun gives the records of an uninterrupted run
and rewrites results.txt with no duplicated line; `results2csv` with and
without `--native` gives the JAX CLI's bytes. The figures need matplotlib
(they skip without it); without matplotlib the campaign still writes its
records and says on stderr that no figure was written.
"""

import json
import sys

import pytest
import torch

from ldpc_sparc_tpu import cli as jcli
from ldpc_sparc_tpu.config import LdpcParams as JLdpcParams
from ldpc_sparc_tpu_torch import cli
from ldpc_sparc_tpu_torch.io import results as tresults

CAMPAIGN = ["ldpc-campaign", "--standard", "802.16", "--rate", "1/2", "--z", "3",
            "--points", "4", "--min-errors", "2", "--max-blocks", "32", "--batch", "8",
            "--max-iters", "10", "--device", "cpu"]
TXT_LINES = [
    "('802.16', '1/2', 3, 'A', -2.8277568533786299, 100, 100, 3600, 1675, 20000)",
    "('802.16', '3/4', 3, 'A', -0.66347569970478615, 100, 100, 5400, 1325, 20000)",
    "('802.11n', '1/2', 27, 3.01, 128, 5, 41472, 57, 3200)",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test process (the suite runs files in parallel)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parse(argv, name):
    """The argparse namespace `cli.main(argv)` hands to cmd_<name>."""
    ns, real = {}, getattr(cli, name)
    try:
        setattr(cli, name, lambda args: ns.setdefault("args", args))
        cli.main(argv)
    finally:
        setattr(cli, name, real)
    return ns["args"]


def _store(out):
    return [json.loads(ln) for ln in (out / "ldpc_campaign.jsonl").read_text().splitlines()]


def test_sim_param_table_is_the_jax_clis():
    assert cli.SIM_PARAM_TABLE == jcli.SIM_PARAM_TABLE
    assert len(cli.SIM_PARAM_TABLE) == 36


@pytest.mark.parametrize("extra", [[], ["--sim-id", "7"], ["--sim-id", "36", "--seed", "3",
                                                           "--dectype", "minsum"]])
def test_campaign_key_is_the_jax_clis(extra):
    args = _parse(CAMPAIGN + extra, "cmd_ldpc_campaign")
    params = cli.campaign_params(args)
    jparams = JLdpcParams(standard=args.standard, rate=args.rate, z=args.z,
                          ptype=args.ptype)
    want = jcli._config_key(params=jparams, points=args.points,
                            min_errors=args.min_errors, max_blocks=args.max_blocks,
                            batch=args.batch, dectype=args.dectype,
                            max_iters=args.max_iters, seed=args.seed)
    assert cli.campaign_config_key(args, params) == want
    if extra:
        assert (params.standard, params.rate, params.z, params.ptype) == \
            jcli.SIM_PARAM_TABLE[int(extra[1]) - 1]


def test_campaign_killed_and_rerun_gives_the_same_records(tmp_path, capsys):
    full = tmp_path / "full"
    recs = cli.main(CAMPAIGN + ["--out", str(full)])
    assert len(recs) == 4 and len(capsys.readouterr().out.splitlines()) == 4
    store = _store(full)
    assert [r["point"] for r in store] == [0, 1, 2, 3]
    assert all(set(r) == {"key", "record", "point", "next_snr", "ctr"} for r in store)
    txt = (full / "results.txt").read_text()
    assert txt == "".join(tresults.record_to_tuple_line(tuple(r)) + "\n" for r in recs)
    # killed after point 1: the store holds its first two cells and nothing else
    cut = tmp_path / "cut"
    cut.mkdir()
    lines = (full / "ldpc_campaign.jsonl").read_text().splitlines(keepends=True)
    (cut / "ldpc_campaign.jsonl").write_text("".join(lines[:2]))
    again = cli.main(CAMPAIGN + ["--out", str(cut)])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [p["point"] for p in printed] == [2, 3]          # resumed, not redone
    assert again == recs and _store(cut) == store
    assert (cut / "results.txt").read_text() == txt
    assert (cut / "results.csv").read_text() == (full / "results.csv").read_text()
    # a rerun of a finished campaign measures nothing and duplicates nothing
    cli.main(CAMPAIGN + ["--out", str(cut)])
    assert capsys.readouterr().out == ""
    assert (cut / "results.txt").read_text() == txt and _store(cut) == store


@pytest.mark.parametrize("native", [False, True])
def test_results2csv_is_the_jax_clis(tmp_path, capsys, native):
    txt = tmp_path / "results.txt"
    txt.write_text("\n".join(TXT_LINES) + "\n")
    flag = ["--native"] if native else []
    cli.main(["results2csv", str(txt), str(tmp_path / "p.csv")] + flag)
    jcli.main(["results2csv", str(txt), str(tmp_path / "j.csv")] + flag)
    assert (tmp_path / "p.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    capsys.readouterr()
    cli.main(["results2csv", str(txt)] + flag)
    assert capsys.readouterr().out == (tmp_path / "j.csv").read_text()
    assert len((tmp_path / "j.csv").read_text().splitlines()) == 3


@pytest.mark.parametrize("out,metric", [("w.pdf", "ber"), ("w.png", "bler")])
def test_plot_results_writes_its_figure(tmp_path, capsys, out, metric):
    pytest.importorskip("matplotlib")
    txt = tmp_path / "results.txt"
    txt.write_text("\n".join(TXT_LINES) + "\n")
    cli.main(["plot-results", str(txt), str(tmp_path / out), "--metric", metric])
    assert (tmp_path / out).stat().st_size > 1000
    assert json.loads(capsys.readouterr().out) == {
        "records": 3, "out": str(tmp_path / out), "metric": metric}
    (tmp_path / "empty.txt").write_text("\n")
    with pytest.raises(SystemExit, match="no measurement records"):
        cli.main(["plot-results", str(tmp_path / "empty.txt"), str(tmp_path / "e.pdf")])


def test_the_three_figures_write_their_files(tmp_path):
    pytest.importorskip("matplotlib")
    recs = []
    for std, z, pt in (("802.11n", 27, "A"), ("802.16", 27, "A"), ("802.16", 27, "B"),
                       ("802.16", 54, "A")):
        for i, snr in enumerate((1.0, 2.0, 3.0)):
            recs.append((std, "2/3", z, pt, snr, 1000, 100 - 30 * i, 64800,
                         5000 // (i + 1), 50000))
    for name in ("w.png", "w.pdf"):
        tresults.plot_waterfalls(recs, tmp_path / name)
    tresults.plot_standard_comparison(recs, str(tmp_path / "c.pdf"))
    tresults.plot_standard_comparison(recs, str(tmp_path / "c.png"), metric="bler")
    rows = [[{"snr": 2.0, "ber": 0.1, "ber_min": 0.05, "ber_max": 0.2},
             {"snr": 4.0, "ber": 0.0, "ber_min": 0.0, "ber_max": 0.0}],
            [{"snr_db": 2.0, "ber": 0.2}, {"snr_db": 4.0, "ber": 0.01}]]
    tresults.plot_ber_sweep(rows, ["a", "b"], tmp_path / "b.png")
    for name in ("w.png", "w.pdf", "c.pdf", "c.png", "b.png"):
        assert (tmp_path / name).stat().st_size > 1000, name


def test_campaign_and_concat_sweep_write_their_figures(tmp_path):
    pytest.importorskip("matplotlib")
    cli.main(CAMPAIGN[:-6] + ["--points", "2", "--batch", "8", "--max-iters", "10",
                              "--device", "cpu", "--out", str(tmp_path / "c")])
    assert (tmp_path / "c" / "waterfall.png").stat().st_size > 1000
    cli.main(["concat-sweep", "--z", "12", "--mults", "2", "--logM", "2", "--t-max", "4",
              "--runs", "2", "--num-snrs", "2", "--snr-start", "3", "--snr-stop", "8",
              "--decoders", "amp_only,sequential", "--device", "cpu",
              "--out", str(tmp_path / "s")])
    assert (tmp_path / "s" / "concat_sweep.png").stat().st_size > 1000


def test_without_matplotlib_the_records_are_written(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    recs = cli.main(CAMPAIGN[:-6] + ["--points", "2", "--batch", "8", "--max-iters", "10",
                                     "--device", "cpu", "--out", str(tmp_path)])
    err = capsys.readouterr().err
    assert err.count("\n") == 1 and "no figure written" in err and "matplotlib" in err
    assert len(recs) == 2 and not (tmp_path / "waterfall.png").exists()
    assert len((tmp_path / "results.txt").read_text().splitlines()) == 2
    assert len((tmp_path / "results.csv").read_text().splitlines()) == 2
    with pytest.raises(SystemExit):
        cli.main(["plot-results", str(tmp_path / "results.txt"), str(tmp_path / "w.pdf")])
    assert "no figure written" in capsys.readouterr().err
    assert not (tmp_path / "w.pdf").exists()


def test_campaign_without_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        return   # a card is present: the CLI would run the campaign on it
    with pytest.raises(SystemExit) as err:
        cli.main(CAMPAIGN[:-2] + ["--out", str(tmp_path)])
    assert "no CUDA device" in str(err.value) and "--device cpu" in str(err.value)
    assert not (tmp_path / "ldpc_campaign.jsonl").exists()
