"""Driver of the LDPC waterfall campaign cells: one call of the program's
`parallel.montecarlo.ldpc_waterfall_campaign` a point, pipelined as the
`ldpc-campaign` CLI runs it, and the check of the points' counts against
the plain reference (`reference/ldpc.py`).

A point is one measured point of the campaign at a fixed size:
`n_measurements=1` at the traffic's `snr_db`, `max_blocks` the traffic's
`blocks_per_point` and `min_errors` one more, so every point decodes the
same whole batches (the pipelined loop's one speculative batch more,
discarded). Point i starts at codeword counter i * blocks_per_point of the
run's seed, so the window's points are disjoint stretches of one campaign
stream.

The cell's traffic file gives `snr_db`, `batch`, `blocks_per_point`,
`check_points` (how many of the window's points, drawn from the seed, the
reference recomputes) and `limits` (one per number compared).

The numbers compared, each summed over the checked points as
|program - reference| of the point's record and taken per block:
`iter_gap` (iterations: how long BP ran and where it stopped),
`blkerr_gap` (block errors) and `biterr_gap` (bit errors: what it
decided). The program returns a point's sums, so opposite shifts of two
blocks of one point cancel.

`dectype` and `max_iters` replace the configuration's on the program's
side alone (the calibration's controls); the reference always decodes as
the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import ldpc as ref

ENTRY = "ldpc_waterfall_campaign"
WARM_POINT = 1 << 40          # the warm-up point's index, never a window's
CHECKED = {"iter_gap": "iters", "blkerr_gap": "errs", "biterr_gap": "bit_errs"}


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 dectype: str | None = None, max_iters: int | None = None):
        from ldpc_sparc_tpu_torch import LdpcParams
        self.cfg, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.ldpc = LdpcParams(config["standard"], config["rate"], int(config["z"]),
                               config.get("ptype", "A"))
        self.dectype = dectype or config["dectype"]
        self.max_iters = int(max_iters or config["max_iters"])
        self.batch = int(traffic["batch"])
        self.trials = int(traffic["blocks_per_point"])
        self.snr_db = float(traffic["snr_db"])

    def point(self, i: int) -> dict:
        """Point i through the program: its record's counts (`errs`, the
        block errors, a numpy integer on both sides, which the calibration's
        frame sums as it sums the concatenated cells' per-trial arrays)."""
        from ldpc_sparc_tpu_torch.parallel.montecarlo import ldpc_waterfall_campaign
        [rec] = ldpc_waterfall_campaign(
            self.ldpc, seed=self.seed, n_measurements=1, start_snr=self.snr_db,
            start_ctr=i * self.trials, max_blocks=self.trials,
            min_errors=self.trials + 1, batch=self.batch, dectype=self.dectype,
            max_iters=self.max_iters, device=self.device)
        nblocks, nblk, _, nbit, nit = rec[5:]
        return {"frames": nblocks, "errs": np.int64(nblk), "bit_errs": nbit,
                "iters": nit}

    def warm(self) -> None:
        """One point of the window's shapes, far from the window's counters."""
        self.point(WARM_POINT)

    def work(self) -> dict:
        """The shapes `k4_roofline` counts a codeword-iteration's work from:
        the code's expansion z, its protograph's check degrees and its edges,
        from the reference's table."""
        code = ref.build_code(self.cfg)
        return {"z": code.z, "check_degrees": ref.check_degrees(code),
                "edges": len(code.row) * code.z}

    def reference(self, i: int, message_dtype: torch.dtype = torch.float32) -> dict:
        """Point i's counts by the plain reference (`message_dtype`
        bfloat16 is the calibration's control)."""
        want = ref.point_counts(self.cfg, self.snr_db, self.seed, i * self.trials,
                                self.trials, self.batch, self.device, message_dtype)
        return {**want, "errs": np.int64(want["errs"])}

    @staticmethod
    def gaps(pairs: list) -> dict:
        """The numbers compared over (program, reference) count pairs."""
        blocks = sum(want["frames"] for _, want in pairs)
        return {name: sum(abs(int(got[key]) - int(want[key])) for got, want in pairs)
                / blocks for name, key in CHECKED.items()}

    def check(self, done: dict) -> dict:
        """Recompute `check_points` of the points in `done` (index ->
        counts), drawn from the seed, with the reference; returns the
        numbers compared and `points`, the indices."""
        k = min(int(self.traffic.get("check_points", 1)), len(done))
        rng = np.random.default_rng([self.seed, 0xC4EC])
        picks = sorted(int(i) for i in rng.choice(sorted(done), k, replace=False))
        return {"points": picks,
                **self.gaps([(done[i], self.reference(i)) for i in picks])}
