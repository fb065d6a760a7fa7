"""Analytic wind forcing (PyTorch port of ``picles_tpu/forcing/winds.py:37-72``).

A wind is a pair of samplers ``u(x, y, t)``, ``v(x, y, t)`` on tensors.  The
Pallas kernels of the JAX package inline any such Python closure; a CUDA
kernel cannot.  So each helper below also attaches a ``WindKernel``
descriptor — a kind plus its float parameters — which is exactly the set
the kernels in ``picles_torch/csrc/rhs.cuh`` compile.  A ``Winds2D``
without a descriptor (any other callable; gridded winds are not ported
yet) runs only on the plain PyTorch path, and the CUDA modes refuse it.

The samplers compute in float32 with the JAX package's operation order.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, NamedTuple, Optional

import torch


class WindKind(enum.IntEnum):
    """Wind families the kernels compile (``WindKind`` in ``rhs.cuh``)."""

    CONSTANT = 0
    HALF_DOMAIN = 1
    TIME_COSINE = 2


@dataclasses.dataclass(frozen=True)
class WindKernel:
    """Kernel-side description of an analytic wind."""

    kind: WindKind
    u0: float
    v0: float
    x_split: float = 0.0
    background: float = 0.0
    period: float = 1.0
    t_off: Optional[float] = None


class Winds2D(NamedTuple):
    """(u, v) sampler pair plus the optional kernel descriptor."""

    u: Callable
    v: Callable
    kernel: Optional[WindKernel] = None

    def __call__(self, x, y, t):
        return self.u(x, y, t), self.v(x, y, t)


def constant_winds(U10: float, V10: float) -> Winds2D:
    """Uniform steady winds."""
    return Winds2D(u=lambda x, y, t: torch.full_like(x, U10, dtype=torch.float32),
                   v=lambda x, y, t: torch.full_like(x, V10, dtype=torch.float32),
                   kernel=WindKernel(WindKind.CONSTANT, U10, V10))


def half_domain_winds(U10: float, V10: float, x_split: float,
                      background: float = 0.0) -> Winds2D:
    """x < x_split -> (U10, V10), else ``background``."""
    def u(x, y, t):
        return torch.where(x < x_split, U10, background).to(torch.float32)

    def v(x, y, t):
        return torch.where(x < x_split, V10, background).to(torch.float32)

    return Winds2D(u=u, v=v, kernel=WindKernel(
        WindKind.HALF_DOMAIN, U10, V10, x_split=x_split,
        background=background))


def time_cosine_winds(U10: float, V10: float, period: float,
                      t_off: Optional[float] = None) -> Winds2D:
    """Growing/decaying winds: amplitude cos(2 pi t / period), optionally
    zeroed after ``t_off``."""
    def amp(t):
        t = torch.as_tensor(t, dtype=torch.float32)
        a = torch.cos(2.0 * math.pi * t / period)
        if t_off is not None:
            a = torch.where(t > t_off, 0.0, a)
        return a

    return Winds2D(u=lambda x, y, t: U10 * amp(t) + 0.0 * x,
                   v=lambda x, y, t: V10 * amp(t) + 0.0 * x,
                   kernel=WindKernel(WindKind.TIME_COSINE, U10, V10,
                                     period=period, t_off=t_off))
