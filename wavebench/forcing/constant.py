"""constant: a uniform steady wind, ``{"kind": "constant", "u": m/s, "v":
m/s}``; the port's ``constant_winds``, which the kernels compute in place
(no planes)."""

from __future__ import annotations

import torch

from wavebench import reference as R


class ConstantWind(R.Wind):
    def __init__(self, u: float, v: float):
        self.u0, self.v0 = float(u), float(v)

    def sample(self, x, y, t):
        return (torch.full_like(x, self.u0, dtype=torch.float32),
                torch.full_like(x, self.v0, dtype=torch.float32))

    def port(self, pt):
        return pt.constant_winds(self.u0, self.v0)


def make(spec: dict, seed: int, device) -> ConstantWind:
    """The mix's wind; a constant wind takes nothing from the seed."""
    return ConstantWind(spec["u"], spec["v"])
