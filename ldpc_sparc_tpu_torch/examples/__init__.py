"""Example scripts of the port, counterparts of the JAX package's
`examples/sparc_demo.py`, `examples/sc_decode_wave.py` and
`examples/concat_probes.py`:

    python -m ldpc_sparc_tpu_torch.examples.sparc_demo [--runs 5]
    python -m ldpc_sparc_tpu_torch.examples.sc_decode_wave [--fwht-mode ms]
    python -m ldpc_sparc_tpu_torch.examples.concat_probes [--seeds 3 --snr 3.8]

Each runs on the card unless `--device cpu` is given, takes `--small` for
a size the CPU decodes in seconds, writes its numbers as JSON with
`--json PATH`, and draws its figure to `--out` where matplotlib is
installed (where it is not, one line on stderr says so and the script
still exits 0). `main(argv)` returns what the JSON holds.
"""

from __future__ import annotations

import sys
import time

import torch


def synchronize(device: torch.device) -> None:
    """Wait for the card's queue, so that a host clock times the work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall(fn, device: torch.device):
    """(fn(), seconds), the work synchronised on both sides."""
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t0


def save_figure(draw, out_path) -> bool:
    """draw(plt) draws onto pyplot, saved to out_path. Where matplotlib is
    missing, say so on stderr and return False."""
    try:
        import matplotlib
    except ModuleNotFoundError:
        print(f"no figure written to {out_path}: matplotlib is not installed",
              file=sys.stderr, flush=True)
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = draw(plt)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    print(f"wrote {out_path}")
    return True
