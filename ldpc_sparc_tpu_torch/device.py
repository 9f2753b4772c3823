"""Which device an entry point runs on.

The port is written for an NVIDIA card: an entry point that is not told
where to run takes the CUDA device, and raises when torch sees none.
`device="cpu"` (or `--device cpu` on the command line) asks for the CPU,
where every kernel wrapper runs its plain version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA device, and raises
    RuntimeError when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device; the port runs on the card "
                           "unless device='cpu' (--device cpu) is given")
    return torch.device("cuda")
