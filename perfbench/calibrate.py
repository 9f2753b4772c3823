"""Readings the check's limits are set from: the numbers a run compares,
for the program on many seeds and for the control on a few, in one process.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--points K] [--out FILE]

For each seed it runs K points (the traffic's `check_points` unless given)
at the cell's own sizes through the program, has the plain reference
recompute them, and prints the numbers `Driver.check` compares (one JSON
line a seed). The control is the program with its bf16 design products
switched on (`fwht_mode="2mm"`, K2 with bf16 operands), the nearest
precision below the float32 that the configurations state. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from perfbench.drivers.sparc_mc import CHECKED
from perfbench.run import make_driver

CONTROL_MODE = "2mm"


def readings(drv, seed: int, points: int) -> dict:
    """The numbers compared on points 0 .. points-1 of `seed`, and a
    closer look at each point."""
    drv.seed = seed
    pairs, look = [], []
    for i in range(points):
        t0 = time.perf_counter()
        got = drv.point(i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = drv.reference(i)
        t2 = time.perf_counter()
        pairs.append((got, want))
        it = want["trial_iters"]
        look.append({"point": i, "program": {k: got[k] for k in CHECKED},
                     "reference": {k: want[k] for k in CHECKED},
                     "ref_trials_at_cap": int((it == drv.decode.t_max - 1).sum()),
                     "ref_iters_median": float(np.median(it)),
                     "program_s": t1 - t0, "reference_s": t2 - t1})
    return {"seed": seed, **drv.gaps(pairs), "look": look}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--points", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    out = open(args.out, "a") if args.out else None
    for mode, seeds in ((None, args.seeds), (CONTROL_MODE, args.control_seeds)):
        if not seeds:
            continue
        traffic, _, drv = make_driver(args.workload, seeds[0], "cuda", fwht_mode=mode)
        drv.warm()
        k = args.points or int(traffic.get("check_points", 1))
        for seed in seeds:
            row = {"workload": args.workload, "side": mode or "program",
                   **readings(drv, seed, k)}
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
        del drv
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
