"""peak_mib: ``torch.cuda.max_memory_allocated()`` from the start of
set-up to the window's end, in MiB: the pool, the forcing, the model, its
capture and the jobs' states."""


def read(run):
    return run.peak_bytes / 2 ** 20 if run.peak_bytes else None
