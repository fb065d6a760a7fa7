"""The traffic's arithmetic: a mix's parameters (``traffic/<mix>.json``)
and ``--seed`` in.

A mix names its forcing's kind (``forcing/<kind>.py``, whose ``make(spec,
seed, device)`` builds the wind from the mix's parameters), its member
pool's parameters (applied to the configuration's state by its family,
``families/<family>.py`` ``members``), its horizon and the member-days it
checks.  Every random draw comes from a stream of the seed named here.
"""

from __future__ import annotations

import numpy as np
import torch


def substream(seed: int, *key: int) -> int:
    """A 63-bit seed for one stream of ``seed`` (forcing, pool, sample)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *key])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device, *key: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(substream(seed, *key))
    return g


def steps_per_job(traffic: dict, DT: float) -> int:
    """The steps of one member's horizon."""
    return int(round(float(traffic["horizon_s"]) / DT))
