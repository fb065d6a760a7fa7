"""setup.capture_s: host seconds of the model's first ``step_n_quiet``
(one step), the card waited for: the eager warm-up steps, the CUDA graph's
capture and one replay."""


def read(run):
    return run.capture_s
