"""Run one benchmark cell once and print its result as one JSON line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell names a traffic file
`perfbench/workloads/<cell>.json`, which names its configuration
(`perfbench/configs/<config>.json`) and its driver
(`perfbench/drivers/<driver>.py`). The run

1. checks that torch sees as many CUDA devices as the cell asks for, and
   exits with code 3 and no result where it does not;
2. builds or loads the program's kernels and warms up with one point of the
   cell's shapes (set-up: process start to the first timed point);
3. runs points back to back until `--seconds` have passed; the window
   closes at the end of the first point that ends after that;
4. with `--trace 1`, profiles whole points from the window's start until
   the traffic's `trace_seconds` have passed, keeping the trace in memory;
5. reads the device's memory peak, exits with code 1 and no result if JAX
   or the JAX package was loaded, frees the program's state and has the
   plain reference recompute points drawn from the seed;
6. prints each number compared beside its limit on standard error, and the
   result line on standard output.

With `--trace 0` the metrics are the cell's end-to-end metrics of
`BENCHMARK.json`, with `--trace 1` its per-layer metrics; each is read by
`perfbench/metrics/<name>.py`, whose `read(run)` returns a number or None
(the metric is then left out). A name `<base>.<suffix>` is the quantity
`<base>` in cells that report another end-to-end metric (a rate with a
bound of its own), read by `<base>.py`.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse                                                    # noqa: E402
import gc                                                          # noqa: E402
import importlib                                                   # noqa: E402
import importlib.util                                              # noqa: E402
import json                                                        # noqa: E402
import os                                                          # noqa: E402
import subprocess                                                  # noqa: E402
import sys                                                         # noqa: E402
from dataclasses import dataclass, field                           # noqa: E402
from pathlib import Path                                           # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
CACHE = ROOT / ".perfbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "ldpc_sparc_tpu")

# the port builds its kernels into its own `_build/` inside the checkout;
# the driver's JIT cache, the one other cache a run can fill, goes beside it
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
os.environ["USE_FLAX"] = "0"

import torch                                                       # noqa: E402


@dataclass
class Run:
    """What a metric reader reads."""
    setup_s: float = 0.0
    window_s: float = 0.0
    points: int = 0
    trials: int = 0
    memory_peak_bytes: int = 0
    work: dict = field(default_factory=dict)
    trace: object = None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader_path(name: str) -> Path:
    """The reader of metric `name`: `metrics/<base>.py` for `<base>.<suffix>`."""
    return BENCH / "metrics" / f"{name.split('.')[0]}.py"


def _reader(name: str):
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end (trace off) or per-layer (trace on) metrics."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def make_driver(cell: str, seed: int, device, config_update=None,
                traffic_update=None, **kw):
    """(traffic, driver module, driver) of `cell`; the updates replace keys
    of its traffic and configuration files (the tests' small sizes)."""
    traffic = {**load_json(BENCH / "workloads" / f"{cell}.json"),
               **(traffic_update or {})}
    config = {**load_json(BENCH / "configs" / f"{traffic['config']}.json"),
              **(config_update or {})}
    mod = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    return traffic, mod, mod.Driver(config, traffic, seed, device, **kw)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device="cuda",
             driver_kw: dict | None = None):
    """One run of `cell` on `device`; returns (result line, [(name, value,
    limit), ...] of the numbers compared)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench.trace import HOST_SPAN, summarize

    bench = load_json(ROOT / "BENCHMARK.json")
    traffic, mod, drv = make_driver(cell, seed, device, **(driver_kw or {}))
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if trace:                          # the profiler's own first-use cost
        with profile(activities=acts):
            torch.zeros(1, device=device).add_(1)
            sync()
    drv.warm()
    sync()
    run = Run(setup_s=time.perf_counter() - T0,
              work=drv.work())

    # the window: whole points until `seconds` have passed
    done, trace_points, traced_s = {}, 0, 0.0
    trace_s = min(float(traffic.get("trace_seconds", 5)), seconds)
    prof = profile(activities=acts) if trace else None
    tracing = trace
    start = time.perf_counter()
    if tracing:
        prof.__enter__()
    while True:
        with record_function(f"{HOST_SPAN}{mod.ENTRY}, outside torch ops"):
            done[len(done)] = drv.point(len(done))
        sync()
        now = time.perf_counter()
        if tracing:
            trace_points += 1
            if now - start >= trace_s or now - start >= seconds:
                prof.__exit__(None, None, None)
                tracing, traced_s = False, now - start
        if now - start >= seconds:
            break
    run.window_s = now - start
    run.points = len(done)
    run.trials = sum(c["frames"] for c in done.values())
    failed = len(done) * drv.trials - run.trials
    if cuda:
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"perfbench: the run loaded {', '.join(bad)}; the port "
                         "must run without JAX")
    if prof is not None:
        run.trace = summarize(prof.events(), traced_s, trace_points)
        del prof

    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = _reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": False, "attempted": len(done) * drv.trials,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else device,
                         "kind": torch.cuda.get_device_name() if cuda else device,
                         "count": 1, "memory_peak_bytes": run.memory_peak_bytes},
              "points": run.points, "window_s": run.window_s}
    if run.trace is not None:
        t = run.trace
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["traced_points"] = t.points
        result["breakdown"] = {"device_ops": t.top_kernels(10),
                               "idle_gaps": t.gaps[:10]}
    if cuda:
        result["power_limit"] = power_limit()

    # the check, once the program's state is freed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    found = drv.check(done)
    result["checked_points"] = found.pop("points")
    checks = [(name, float(found[name]), float(limit))
              for name, limit in traffic["limits"].items()]
    result["correct"] = failed == 0 and all(v <= lim for _, v, lim in checks)
    result["check"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"perfbench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
