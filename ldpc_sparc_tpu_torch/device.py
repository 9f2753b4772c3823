"""Which device an entry point runs on.

The port is written for an NVIDIA card: an entry point that is not told
where to run takes the CUDA device, and raises when torch sees none.
`device="cpu"` (or `--device cpu` on the command line) asks for the CPU,
where every kernel wrapper runs its plain version.

`all_reduce` is the one collective the port's modules share: the mesh's
'dp' sums (`parallel/`) and the 'sec' sums of the section-sharded AMP loop
(`models/sparc.py::amp_decode`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA device, and raises
    RuntimeError when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device; the port runs on the card "
                           "unless device='cpu' (--device cpu) is given")
    return torch.device("cuda")


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of `t` over `group` (complex as its real view);
    returns t. A card's tensor in a gloo group (several ranks on one card)
    is staged through host memory, which is how gloo moves it anyway."""
    v = torch.view_as_real(t) if t.is_complex() else t
    if v.is_cuda and dist.get_backend(group) == "gloo":
        host = v.cpu()
        dist.all_reduce(host, op=op, group=group)
        v.copy_(host)
    else:
        dist.all_reduce(v, op=op, group=group)
    return t
