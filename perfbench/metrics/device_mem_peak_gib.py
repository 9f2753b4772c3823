"""`torch.cuda.max_memory_allocated()` over the run, set-up included, in GiB."""


def read(run):
    return run.memory_peak_bytes / 2**30 if run.memory_peak_bytes else None
