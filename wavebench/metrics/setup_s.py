"""setup_s: seconds from the start of the process to the first timed job:
imports, the kernel libraries' load (or build, in a checkout's first run),
the forcing, the grids, the pool, the model, its capture and a warm
member-day."""


def read(run):
    return run.setup_s
