"""The control comes out not correct: the program with its bf16 design
products (`fwht_mode="2mm"`, K2 with bf16 operands, the nearest precision
below the float32 the configurations state), at each cell's own sizes on
the card, is held to the cell's limits by the cell's own comparison, and
fails at least one of them; the program as configured passes them.
One seed and the cell's checked points each (`perfbench.calibrate` reads
a dozen)."""

import pytest

from perfbench.calibrate import CONTROL_MODE, readings
from perfbench.run import make_driver

CELLS = ["sparc_flagship.deep_6db", "sparc_sc_large.wave_snr15"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, card):
    for mode, seed in ((None, 2**31 + 401), (CONTROL_MODE, 2**31 + 402)):
        traffic, _, drv = make_driver(cell, seed, card, fwht_mode=mode)
        drv.warm()
        got = readings(drv, seed, int(traffic["check_points"]))
        over = [k for k, lim in traffic["limits"].items() if got[k] > lim]
        assert bool(over) == (mode == CONTROL_MODE), (mode, got)
