"""The cells cut to a few hundred nodes and a few steps, for the CPU
tests."""

SMALL = {
    "box1536.steady-day": {
        "config": {"grid": {"nx": 32, "ny": 32}},
        "traffic": {"horizon_s": 2400.0}},
}
CELLS = tuple(SMALL)
