"""Readings the campaign cells' limits are set from: the numbers
`drivers/ldpc_campaign.Driver.check` compares, for the program on many
seeds and for five controls on a few, in one process.

    python3 -m perfbench.calibrate_campaign --workload <cell> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--controls a b c d e] [--points K] [--out FILE]

The frame is `calibrate_concat.py`'s (its `main` and `readings`, run with
this module's controls): for each seed the plain reference computes points
0 .. K-1 once; the program and each control run those points and go
through `Driver.check` against it and the traffic's limits, as a run's
window does. One JSON line a (side, seed). The controls:

  a  min-sum (scaled by 0.7) in place of sum-product
  b  at most 199 BP iterations in place of 200
  c  the plain reference with its messages rounded to bfloat16 after each
     update (`message_dtype=torch.bfloat16`) in the program's place: the
     nearest precision below the float32 the configuration states
  d  half of each batch decoded and its counts counted twice
  e  one decision altered in every batch (the first code bit of its first
     codeword flipped)
"""

from __future__ import annotations

import contextlib
import sys
from unittest import mock

import torch

from perfbench import calibrate_concat as frame

CONTROLS = {"a": {"dectype": "minsum"}, "b": {"max_iters": 199},
            "c": {}, "d": {}, "e": {}}


def half_batch(batch_counts):
    """A campaign `_batch_counts` that draws the whole batch, decodes its
    first half and counts that half twice."""
    def run(code, snr_db, gen, batch, max_iters, dectype, bp_kernel,
            part=slice(None)):
        return 2 * batch_counts(code, snr_db, gen, batch, max_iters, dectype,
                                bp_kernel, slice(0, batch // 2))
    return run


def altered_answer(bp_decode):
    """A `bp_decode` whose decision on the first code bit of the batch's
    first codeword is flipped."""
    def run(*a, **k):
        res = bp_decode(*a, **k)
        app = res.app.clone()
        app[0, 0] = torch.where(app[0, 0] < 0, 1.0, -1.0)
        return res._replace(app=app)
    return run


@contextlib.contextmanager
def control(name: str, drv):
    """The program as control `name` runs it (a and b go through `Driver`'s
    arguments; c puts the bfloat16 reference in `drv`'s program's place)."""
    from ldpc_sparc_tpu_torch.parallel import montecarlo
    real = montecarlo._batch_counts, montecarlo.bp_decode
    try:
        if name == "c":
            drv.point = lambda i: drv.reference(i, message_dtype=torch.bfloat16)
        elif name == "d":
            montecarlo._batch_counts = half_batch(real[0])
        elif name == "e":
            montecarlo.bp_decode = altered_answer(real[1])
        yield
    finally:
        montecarlo._batch_counts, montecarlo.bp_decode = real
        drv.__dict__.pop("point", None)


def main(argv=None) -> int:
    with mock.patch.multiple(frame, CONTROLS=CONTROLS, control=control,
                             __doc__=__doc__):
        return frame.main(argv)


if __name__ == "__main__":
    sys.exit(main())
