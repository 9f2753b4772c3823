"""Driver of the SPARC Monte Carlo cells: one call of the program's
`parallel.montecarlo.sparc_mc_counts` a point, as `sparc_ber_sweep` makes
it (point i seeded (seed, i), n_designs = min(designs, trials)), and the
check of the points' counters against the plain reference
(`reference/sparc.py`).

The cell's traffic file gives `snr` (a list; point i takes entry
i mod len, awgn_var = P / snr), `trials_per_point`, `designs`,
`check_points` (how many of the window's points, drawn from the seed, the
reference recomputes) and `limits` (one per number compared).

The numbers compared, each summed over the checked points and taken per
trial: `iter_gap`, sum |iters - reference iters| / trials (the AMP loop
and its stop rule), `frame_err_gap`, `sec_err_gap`, `bit_err_gap`
likewise (the decisions, the MAP step and the counters), and
`iter_sec_gap`, iterations and section errors together: the decoder's
two outputs a trial, how long it ran and what it decided, with no weight
by the bits a wrong section flips.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import sparc as ref

ENTRY = "sparc_mc_counts"
CHECKED = ("iters", "frame_errs", "sec_errs", "bit_errs")
WARM_POINT = 1 << 40          # the warm-up point's index, never a window's


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 fwht_mode: str | None = None):
        from ldpc_sparc_tpu_torch import DecodeParams, SparcParams
        keys = ("P", "R", "L", "M", "spatially_coupled", "omega", "Lambda",
                "power_allocated", "B", "R_PA_ratio")
        self.cfg, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.params = SparcParams(**{k: config[k] for k in keys if k in config})
        self.decode = DecodeParams(t_max=int(config["t_max"]),
                                   rtol=float(config.get("rtol", 1e-6)),
                                   phi_est_method=int(config.get("phi_est_method", 1)))
        self.fwht_mode = fwht_mode or config.get("fwht_mode", "ms")
        self.trials = int(traffic["trials_per_point"])
        self.designs = min(int(traffic["designs"]), self.trials)
        self.snr = [float(s) for s in traffic["snr"]]

    def awgn_var(self, i: int) -> float:
        return float(self.cfg["P"]) / self.snr[i % len(self.snr)]

    def point(self, i: int) -> dict:
        """Point i through the program; its counters."""
        from ldpc_sparc_tpu_torch.parallel.montecarlo import sparc_mc_counts
        return sparc_mc_counts(self.params, self.decode, self.awgn_var(i),
                               (self.seed, i), self.trials, self.designs,
                               engine=self.cfg.get("engine", "srht"),
                               fwht_mode=self.fwht_mode, device=self.device,
                               fused_denoiser=self.cfg.get("fused_denoiser"))

    def warm(self) -> None:
        """One point of the window's shapes (its first SNR), outside it."""
        self.point(WARM_POINT - WARM_POINT % len(self.snr))

    def work(self) -> dict:
        """The shapes the per-layer metrics count work from."""
        W, n, bit_len = ref.code_shape(self.cfg)
        L, M = int(self.cfg["L"]), int(self.cfg["M"])
        Lr, Lc = W.shape
        large = max(n // Lr, L * M // Lc)
        w = large if large & (large - 1) == 0 else 1 << large.bit_length()
        return {"rows": self.trials // self.designs, "decodes": self.designs,
                "t_max": int(self.cfg["t_max"]), "n": n, "LM": L * M, "L": L,
                "M": M, "E": int(np.count_nonzero(W)), "w": w}

    def reference(self, i: int) -> dict:
        """Point i's counters by the plain reference."""
        return ref.point_counts(self.cfg, self.awgn_var(i), (self.seed, i),
                                self.trials, self.designs, self.device)

    @staticmethod
    def gaps(pairs: list) -> dict:
        """The numbers compared over (program, reference) counter pairs."""
        trials = sum(want["frames"] for _, want in pairs)
        gaps = {f"{name.removesuffix('s')}_gap":
                sum(abs(got[name] - want[name]) for got, want in pairs) / trials
                for name in CHECKED}
        return {**gaps, "iter_sec_gap": gaps["iter_gap"] + gaps["sec_err_gap"]}

    def check(self, done: dict) -> dict:
        """Recompute `check_points` of the points in `done` (index ->
        counters), drawn from the seed, with the reference; returns the
        numbers compared and `points`, the indices."""
        k = min(int(self.traffic.get("check_points", 1)), len(done))
        rng = np.random.default_rng([self.seed, 0xC4EC])
        picks = sorted(int(i) for i in rng.choice(sorted(done), k, replace=False))
        return {"points": picks,
                **self.gaps([(done[i], self.reference(i)) for i in picks])}
