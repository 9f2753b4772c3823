"""Readings the concatenated cells' limits are set from: the numbers
`drivers/concat_mc.Driver.check` compares, for the program on many seeds
and for five controls on a few, in one process.

    python3 -m perfbench.calibrate_concat --workload <cell> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--controls a b c d e] [--points K] [--out FILE]

For each seed the plain reference computes points 0 .. K-1 once (K the
traffic's `check_points` unless given); the program and each control run
those points and go through `Driver.check` against it and the traffic's
limits, as a run's window does. One JSON line a (side, seed), with the
numbers compared, `over` (the limits they pass) and `correct`. The
controls:

  a  the standard Onsager term in place of the integrated decoder's
     derivative (`decoder="naive"`, the same loop otherwise)
  b  5 inner BP iterations a step in place of 6
  c  the plain reference with its decoder's transform on bfloat16 operands
     (`precision="bfloat16"`) in the program's place: the nearest
     precision below the float32 the configuration states
  d  half of each batch decoded, its outputs counted twice
  e  one decision altered in every trial (its first user bit flipped)

Control seeds not among `--seeds` get a reference of their own.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from perfbench.run import make_driver

CONTROLS = {"a": {"decoder": "naive"}, "b": {"bp_inner_iters": 5},
            "c": {}, "d": {}, "e": {}}


def half_batch(decode_soft):
    """A `ConcatCodec.decode_soft` that decodes the first half of the trials
    and hands their outputs out twice."""
    from ldpc_sparc_tpu_torch.models.concat import ConcatDecode

    def run(self, ys, designs, *a, **k):
        B, h = ys.shape[0], (ys.shape[0] + 1) // 2
        half = designs.for_trials(torch.arange(h, device=ys.device))
        out = decode_soft(self, ys[:h], half, *a, **k)
        return ConcatDecode(*(torch.cat([v, v])[:B] for v in out))
    return run


def altered_answer(decode_soft):
    """A `ConcatCodec.decode_soft` whose first user bit of every trial is
    flipped."""
    def run(self, *a, **k):
        out = decode_soft(self, *a, **k)
        bits = out.bits.clone()
        bits[:, 0] ^= 1
        return out._replace(bits=bits)
    return run


@contextlib.contextmanager
def control(name: str, drv):
    """The program as control `name` runs it (a and b go through `Driver`'s
    arguments; c puts the bfloat16 reference in `drv`'s program's place)."""
    from ldpc_sparc_tpu_torch.models.concat import ConcatCodec
    real = ConcatCodec.decode_soft
    try:
        if name == "c":
            drv.point = lambda i: drv.reference(i, precision="bfloat16")
        elif name in ("d", "e"):
            ConcatCodec.decode_soft = {"d": half_batch, "e": altered_answer}[name](real)
        yield
    finally:
        ConcatCodec.decode_soft = real
        drv.__dict__.pop("point", None)


def readings(drv, seed: int, points: int, wants: list) -> dict:
    """Points 0 .. points-1 of `seed` through `drv`, held by `drv.check`
    (against the reference's outputs `wants`) to the traffic's limits; the
    program's seconds a point."""
    drv.seed = seed
    done, secs = {}, []
    for i in range(points):
        t0 = time.perf_counter()
        done[i] = drv.point(i)
        if drv.device.type == "cuda":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    drv.reference = wants.__getitem__
    try:
        found = drv.check(done)
    finally:
        del drv.reference
    over = [k for k, lim in drv.traffic["limits"].items() if found[k] > lim]
    picks = found["points"]
    return {**found, "over": over, "correct": not over, "program_s": secs,
            "errs": [int(done[i]["errs"].sum()) for i in picks],
            "ref_errs": [int(wants[i]["errs"].sum()) for i in picks]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--controls", nargs="*", default=sorted(CONTROLS),
                    choices=sorted(CONTROLS))
    ap.add_argument("--points", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate_concat: needs a CUDA device", file=sys.stderr)
        return 3
    traffic, _, drv = make_driver(args.workload, 0, args.device)
    drv.warm()
    k = args.points or int(traffic.get("check_points", 1))
    refs = {}                              # seed -> (outputs, seconds)
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        drv.seed = seed
        t0 = time.perf_counter()
        wants = [drv.reference(i) for i in range(k)]
        refs[seed] = wants, time.perf_counter() - t0
    sides = [("program", None, args.seeds)] + [
        (name, name, args.control_seeds) for name in args.controls]
    out = open(args.out, "a") if args.out else None
    try:
        for side, name, seeds in sides:
            _, _, d = make_driver(args.workload, 0, args.device,
                                  **(CONTROLS[name] if name else {}))
            with control(name, d) if name else contextlib.nullcontext():
                for seed in seeds:
                    wants, ref_s = refs[seed]
                    row = {"workload": args.workload, "side": side, "seed": seed,
                           "reference_s": ref_s, **readings(d, seed, k, wants)}
                    line = json.dumps(row)
                    print(line, flush=True)
                    if out:
                        out.write(line + "\n")
                        out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
