"""``correct`` comes out false under the control and under each fault the
cells can have, with the rest of a run driven as the command drives it (the
look for a card skipped, the tests' size on the CPU):

- the control: the family's, for ``wave_growth_2d`` the reference with its
  particle and node state rounded to bfloat16 after every step, in the
  port's place;
- a step that returns its state unchanged;
- half of the particles left out of the step (their state kept);
- an answer altered where it is produced (the energy of the first eighth
  of the rows of each finished member-day's state raised by a tenth, as a
  wrong tile would).

A single card has no exchange between chips to leave out."""

import dataclasses
import time

import pytest
import torch

import picles_torch as pt
from wavebench import compare
from wavebench.harness import Bench, Cell, run_cell

from cases import CELLS, SMALL


def failing(out) -> set:
    """The checks a run's line reports beyond their limits."""
    return {k for k, c in out["checks"].items()
            if not c["value"] <= c["limit"]}


def run(name, seed=2 ** 31 + 99):
    return run_cell(Bench(), name, seed, 0.5, False, "cpu",
                    time.perf_counter(), overrides=SMALL[name],
                    log=lambda m: None, warm_s=0.0)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    assert run(name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The family's control (the bfloat16-state reference) against the
    float32 reference, on the compared numbers and their limits."""
    c = Cell(Bench(), name, 21, "cpu", SMALL[name],
             log=lambda m: None)
    c.setup(0.0)
    ref = c.reference_model()
    member = next(iter(c.members(ref)))
    want, _ = ref.run(member, c.steps)
    got = c.family.control(ref, member, c.steps)
    gaps = compare.state_gaps(c.family.final(got), c.family.final(want))
    assert not all(compare.passes(v, c.limits[k])
                   for k, v in gaps.items() if k in c.limits), gaps


@pytest.mark.parametrize("name", CELLS)
def test_unchanged_state_fails(name, monkeypatch):
    monkeypatch.setattr(pt.WaveGrowth2D, "step", lambda self, ms: ms)
    out = run(name)
    assert not out["correct"]
    assert "clock" in failing(out)


@pytest.mark.parametrize("name", CELLS)
def test_half_the_particles_left_out_fails(name, monkeypatch):
    step = pt.WaveGrowth2D.step

    def half(self, ms):
        new = step(self, ms)
        nx = ms.state.shape[0]
        keep = torch.zeros(ms.state.shape[:2], dtype=torch.bool)
        keep[nx // 2:] = True

        def pick(a, b):
            k = keep.reshape(keep.shape + (1,) * (a.dim() - 2))
            return torch.where(k, a, b)

        parts = pt.Particles2D(*(pick(a, b) for a, b in zip(
            ms.particles.leaves(), new.particles.leaves())))
        return dataclasses.replace(new, particles=parts,
                                   state=pick(ms.state, new.state))

    monkeypatch.setattr(pt.WaveGrowth2D, "step", half)
    out = run(name)
    assert not out["correct"]
    assert failing(out) & {"gap_l2", "gap_max", "gap_share"}


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_fails(name, monkeypatch):
    run_ = pt.Simulation.run

    def altered(self, *a, **k):
        run_(self, *a, **k)
        s = self.state.state.clone()
        s[: s.shape[0] // 8, :, 0] *= 1.1
        self.state = dataclasses.replace(self.state, state=s)

    monkeypatch.setattr(pt.Simulation, "run", altered)
    out = run(name)
    assert not out["correct"]
    assert "gap_share" in failing(out)


def test_one_altered_node_fails_the_box(monkeypatch):
    """On the box a single node's energy raised by half the field's
    largest fails ``gap_max``."""
    run_ = pt.Simulation.run

    def altered(self, *a, **k):
        run_(self, *a, **k)
        s = self.state.state.clone()
        i, j = (s[..., 0] > 0).nonzero()[0].tolist()
        s[i, j, 0] += 0.5 * s[..., 0].max()
        self.state = dataclasses.replace(self.state, state=s)

    monkeypatch.setattr(pt.Simulation, "run", altered)
    out = run("box1536.steady-day")
    assert not out["correct"]
    assert "gap_max" in failing(out)
