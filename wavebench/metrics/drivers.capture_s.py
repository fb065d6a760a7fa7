"""drivers.capture_s: host seconds of the port's span ``drivers.capture``
in set-up: the eager warm-up steps, the CUDA graph's capture and its
instantiation (``setup.capture_s`` adds the first replay and the wait)."""

from wavebench import spans


def read(run):
    return spans.capture_s()
