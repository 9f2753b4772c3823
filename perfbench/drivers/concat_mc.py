"""Driver of the concatenated LDPC-SPARC cells: one call of the program's
`parallel.montecarlo.concat_mc_counts` a point, as `concat-sweep` makes it
(point i seeded (seed, i)), and the check of each trial's outputs against
the plain reference (`reference/concat.py`).

The cell's traffic file gives `snr` (a list; point i takes entry i mod
len, awgn_var = P / snr, linear SNR as `concat-sweep` has it),
`trials_per_point`, `designs` (n_designs = min(designs, trials)),
`check_points` (how many of the window's points, drawn from the seed, the
reference recomputes) and `limits` (one per number compared).

The numbers compared, over the trials of the checked points:
`err_gap`, sum |errs - reference| / trials (what the decode decided);
`bp_iter_gap`, sum |bp_iters - reference| / trials (how long BP ran inside
the denoiser and at the end); `tau_gap`, the mean over trials and AMP steps
of |ln tau^2 - ln reference tau^2| (the soft trajectory that the Onsager
term, the bridges and BP shape together).

`decoder` and `bp_inner_iters` replace the configuration's on the
program's side alone (the calibration's controls); the reference always
decodes as the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import concat as ref

ENTRY = "concat_mc_counts"
WARM_POINT = 1 << 40          # the warm-up point's index, never a window's


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 decoder: str | None = None, bp_inner_iters: int | None = None):
        from ldpc_sparc_tpu_torch import (DecodeParams, LdpcParams, SparcParams,
                                          get_code, param_calc)
        self.cfg, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.ldpc = LdpcParams(config["standard"], config["rate"], int(config["z"]),
                               config.get("ptype", "A"))
        K = get_code(self.ldpc.standard, self.ldpc.rate, self.ldpc.z, self.ldpc.ptype).K
        logM = int(config["logM"])
        _, _, L, self.lengths = param_calc(int(config["mults"]), logM, self.ldpc,
                                           self.ldpc.rate_float, float(config["R"]), K)
        self.params = SparcParams(P=float(config["P"]), R=float(config["R"]), L=L,
                                  M=1 << logM)
        self.decode = DecodeParams(t_max=int(config["t_max"]))
        self.decoder = decoder or config["decoder"]
        self.bp_inner = int(bp_inner_iters or config["bp_inner_iters"])
        self.trials = int(traffic["trials_per_point"])
        self.designs = min(int(traffic["designs"]), self.trials)
        self.snr = [float(s) for s in traffic["snr"]]

    def awgn_var(self, i: int) -> float:
        return float(self.cfg["P"]) / self.snr[i % len(self.snr)]

    def point(self, i: int) -> dict:
        """Point i through the program; its counters and per-trial outputs."""
        from ldpc_sparc_tpu_torch.parallel.montecarlo import concat_mc_counts
        return concat_mc_counts(self.params, self.ldpc, self.lengths, True,
                                self.decode, self.awgn_var(i), (self.seed, i),
                                self.trials, self.decoder, n_designs=self.designs,
                                device=self.device, bp_inner_iters=self.bp_inner,
                                bp_final_iters=int(self.cfg["bp_final_iters"]))

    def warm(self) -> None:
        """One point of the window's shapes (its first SNR), outside it."""
        self.point(WARM_POINT - WARM_POINT % len(self.snr))

    def work(self) -> dict:
        """The shapes the per-layer metrics count work from: one decode of
        every trial, its products through one block of width w (the offset-1
        window above max(n, L M), as the design builds it)."""
        L, M, n = self.params.L, self.params.M, self.params.n
        return {"rows": self.trials, "decodes": 1, "t_max": self.decode.t_max,
                "L": L, "M": M, "LM": L * M, "n": n, "E": 1,
                "w": 1 << max(n, L * M).bit_length()}

    def reference(self, i: int, precision: str = "float32") -> dict:
        """Point i's per-trial outputs by the plain reference (`precision`
        its decoder's transform's: "bfloat16" is the calibration's control)."""
        return ref.point_outputs(self.cfg, self.awgn_var(i), (self.seed, i),
                                 self.trials, self.designs, self.device, precision)

    @staticmethod
    def gaps(pairs: list) -> dict:
        """The numbers compared over (program, reference) output pairs."""
        trials = sum(want["frames"] for _, want in pairs)
        cat = lambda side, key: np.concatenate([p[side][key] for p in pairs])
        tau = (np.log(cat(0, "tau_sqr").astype(np.float64))
               - np.log(cat(1, "tau_sqr").astype(np.float64)))
        return {"err_gap": float(np.abs(cat(0, "errs") - cat(1, "errs")).sum()) / trials,
                "bp_iter_gap": float(np.abs(cat(0, "bp_iters") - cat(1, "bp_iters")).sum())
                / trials,
                "tau_gap": float(np.abs(tau).mean())}

    def check(self, done: dict) -> dict:
        """Recompute `check_points` of the points in `done` (index ->
        outputs), drawn from the seed, with the reference; returns the
        numbers compared and `points`, the indices."""
        k = min(int(self.traffic.get("check_points", 1)), len(done))
        rng = np.random.default_rng([self.seed, 0xC4EC])
        picks = sorted(int(i) for i in rng.choice(sorted(done), k, replace=False))
        return {"points": picks,
                **self.gaps([(done[i], self.reference(i)) for i in picks])}
