"""Multi-step drivers (PyTorch port of ``picles_tpu/models/drivers.py``).

The JAX package compiles these as ``scan`` / ``fori_loop``; PyTorch runs
eagerly, so they are Python loops over ``self.step``.  None of them reads
the device, so steps queue on the card without host round-trips.
"""

from __future__ import annotations

import torch


class StepDrivers:
    """Mixin: multi-step loops over ``self.step(state) -> state``."""

    def step_n(self, ms, n: int):
        """n steps; returns (final state, stacked Eulerian states
        ``[n, nx, ny, 3]``)."""
        states = []
        for _ in range(n):
            ms = self.step(ms)
            states.append(ms.state)
        if not states:
            return ms, ms.state.new_zeros((0,) + tuple(ms.state.shape))
        return ms, torch.stack(states)

    def step_n_buffered(self, ms, n: int, capacity: int):
        """``step_n`` into a ``capacity``-row buffer; rows past ``n`` stay
        zero.  Returns (final state, buffer)."""
        if n > capacity:
            raise ValueError(f"n={n} exceeds the buffer capacity {capacity}")
        buf = ms.state.new_zeros((capacity,) + tuple(ms.state.shape))
        for i in range(n):
            ms = self.step(ms)
            buf[i] = ms.state
        return ms, buf

    def step_n_quiet(self, ms, n: int):
        """n steps with no per-step output."""
        for _ in range(n):
            ms = self.step(ms)
        return ms
