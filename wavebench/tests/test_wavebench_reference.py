"""The frozen plain reference against the port's plain path on the CPU, at
a few hundred nodes: the grid, the seeds, a member's steps, and the
deposit's folds."""

import pytest
import torch

import picles_torch as pt
from wavebench import compare
from wavebench import reference as R
from wavebench.harness import Bench, Cell

from cases import CELLS, SMALL


def small_cell(name, seed=11):
    c = Cell(Bench(), name, seed, "cpu", SMALL[name],
             log=lambda m: None)
    c.setup(0.0)
    return c


@pytest.mark.parametrize("name", CELLS)
def test_grids_match_the_port(name):
    c = small_cell(name)
    g, r = c.model.grid, c.ref_grid_host
    for a, b in ((g.x, r.x), (g.y, r.y), (g.proj, r.M), (g.pc, r.pc),
                 (g.mask, r.mask)):
        assert torch.equal(a, b)
    assert (int(g.stats.bx), int(g.stats.by)) == (r.bx, r.by)
    assert c.proj is (c.model.uniform_proj is None)


@pytest.mark.parametrize("name", CELLS)
def test_seeds_match_the_ports_init_state(name):
    c = small_cell(name)
    base = c.family.seeded(c.reference_model())
    want = c.model.init_state()
    p = want.particles
    for a, b in ((p.lne, base.lne), (p.cgx, base.cgx), (p.cgy, base.cgy),
                 (p.on, base.on)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", CELLS)
def test_member_days_match_the_ports_plain_path(name):
    """Bit for bit: the final node state and every particle plane."""
    c = small_cell(name)
    k = 3
    out = c.job(c.pool[k])
    ref = c.reference_model()
    member = list(c.members(ref))[k]
    r, counts = ref.run(member, c.steps)
    assert counts["n_active"] > 0 and counts["tried"] >= counts["n_active"]
    assert float(out.time) == float(r.time) == c.steps * c.DT
    gaps = compare.state_gaps(*c.family.compared(out, r))
    assert (gaps["gap_l2"], gaps["gap_max"], gaps["gap_share"]) == (
        0.0, 0.0, 0.0)
    P = out.particles
    for a, b in ((P.lne, r.lne), (P.cgx, r.cgx), (P.px, r.px),
                 (P.dt, r.dt), (P.on, r.on)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("by", ["PERIODIC", "TRIPOLAR_NORTH"])
def test_deposit_folds_match_the_port(by):
    """The deposit over the periodic and the tripolar north folds, with
    displacements that cross them."""
    from picles_torch.ops import pic

    g = torch.Generator().manual_seed(5)
    nx, ny = 16, 10
    xr = torch.rand((nx, ny), generator=g) * 6 - 3
    yr = torch.rand((nx, ny), generator=g) * 6 - 3
    ch = torch.rand((nx, ny, 3), generator=g)
    act = torch.rand((nx, ny), generator=g) < 0.9
    stats = pt.GridStats(nx=nx, ny=ny, bx=pt.Boundary.PERIODIC,
                         by=getattr(pt.Boundary, by))
    want, st = pic.scatter_dense(xr, yr, ch, act, stats, 3)
    got, clamped = R.deposit(xr, yr, ch, act, R.PERIODIC, getattr(R, by), 3)
    assert torch.equal(got, want) and clamped == int(st.clamped)


@pytest.mark.parametrize("name", CELLS)
def test_gathering_live_lanes_keeps_the_day(name):
    """The advance's loop over the live lanes only (as it runs on the
    card): on the CPU within an ulp's growth of the loop over every lane
    (a transcendental's vector body and tail part there)."""
    c = small_cell(name)
    days = []
    for compact in (False, True):
        ref = R.Model(c.ref_grid_host, c.wind, c.ref_settings,
                      compact=compact)
        member = list(c.members(ref))[1]
        days.append(ref.run(member, c.steps))
    (a, ca), (b, cb) = days
    gaps = compare.state_gaps(b.S, a.S)
    assert gaps["gap_l2"] < 1e-4 and gaps["gap_share"] < 0.01, gaps
    assert ca["n_active"] == cb["n_active"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_gathering_live_lanes_is_exact_on_the_card(cuda_device, name):
    c = Cell(Bench(), name, 11, cuda_device, SMALL[name],
             log=lambda m: None)
    c.setup(0.0)
    days = []
    for compact in (False, True):
        ref = R.Model(c.ref_grid_host.to(cuda_device), c.wind,
                      c.ref_settings, compact=compact)
        member = list(c.members(ref))[1]
        days.append(ref.run(member, c.steps))
    (a, ca), (b, cb) = days
    assert torch.equal(a.S, b.S) and ca == cb
