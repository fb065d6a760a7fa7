"""Particle <-> node state transforms (PyTorch port of
``picles_tpu/ops/transforms.py``).

particle (lne, cg_x, cg_y) -> node (E, m_x, m_y): E = exp(lne),
m = cg E / (2 |cg|^2); node -> particle: cg = m E / (2 |m|^2), lne = log E.
In 1D, m_x = E / (2 cg_x) and cg_x = E / (2 m_x), both signed.
Denominators carry the JAX package's tiny floor (signed in 1D), because
both sides of every ``where`` are evaluated.
"""

from __future__ import annotations

import torch

_TINY = 1e-30


def particle_to_node(lne, cg_x, cg_y):
    """(E, m_x, m_y) from particle state."""
    e = torch.exp(lne)
    c2 = torch.clamp(cg_x * cg_x + cg_y * cg_y, min=_TINY)
    m_x = cg_x * e / c2 / 2.0
    m_y = cg_y * e / c2 / 2.0
    return e, m_x, m_y


def node_to_particle(e, m_x, m_y):
    """(lne, cg_x, cg_y) from node state."""
    m2 = torch.clamp(m_x * m_x + m_y * m_y, min=_TINY)
    e_safe = torch.clamp(e, min=_TINY)
    cg_x = m_x * e_safe / (2.0 * m2)
    cg_y = m_y * e_safe / (2.0 * m2)
    return torch.log(e_safe), cg_x, cg_y


def particle_to_node_1d(lne, cg_x):
    """1D (E, m_x) from (lne, cg_x): m_x = E / (2 cg_x)."""
    e = torch.exp(lne)
    cg_safe = torch.where(torch.abs(cg_x) < _TINY, _TINY, cg_x)
    return e, e / cg_safe / 2.0


def node_to_particle_1d(e, m_x):
    """1D (lne, cg_x) from (E, m_x): cg_x = E / (2 m_x)."""
    e_safe = torch.clamp(e, min=_TINY)
    m_safe = torch.where(torch.abs(m_x) < _TINY, _TINY, m_x)
    return torch.log(e_safe), e_safe / (2.0 * m_safe)
