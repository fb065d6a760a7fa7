"""box1536: the periodic Cartesian box of 1536 x 1536 nodes 2 km apart
(the configuration's sizes are in ``box1536.json``), for the port and for
the plain reference."""

from __future__ import annotations


def grids(cfg: dict, device):
    """(the port's grid, the reference's grid): the same box."""
    import picles_torch as pt

    from wavebench import reference as R

    g = cfg["grid"]
    nx, ny, h = int(g["nx"]), int(g["ny"]), float(g["spacing_m"])
    prog = pt.cartesian_box(h * (nx - 1), nx, h * (ny - 1), ny,
                            periodic_boundary=(True, True), device=device)
    return prog, R.box_grid(nx, ny, h, device)
