"""Block-decomposed model step on ``torch.distributed`` (PyTorch port of
``picles_tpu/parallel/sharded.py``).

The ``[nx, ny]`` grid and particle planes are cut into equal blocks over a
2D mesh of ranks, one block a rank: rank ``r`` holds block ``(r // ny_dev,
r % ny_dev)``, as ``devices.reshape(shape)`` lays out the JAX mesh.  Every
stage of the step is elementwise on the block but the CIC deposit, whose
traffic between blocks is exactly the halo slabs of the padded accumulator:

- each rank deposits its block into ``[nx_b+xl+xh, ny_b+yl+yh]`` (kernel K4,
  ``ops/pic_cuda.pic_gather_padded``, on a card: its float32 or float64
  instance by the model's dtype; its plain version
  ``pic.scatter_accumulate_padded`` on the CPU);
- the x slabs go one step along the mesh's x ring and are added to the
  neighbour's core rows, then the y slabs are cut from the x-folded planes
  (corners included) and go one step along the y ring.  A periodic ring
  wraps (a ring of one block adds its own slabs, no message); an open axis
  has no wrap link, so its edge blocks drop what would leave the domain;
- the tripolar north seam all-gathers the top halo along the top row of
  blocks, flips it in x and adds each block's slice back
  (``pic.fold_padded_y``'s tripolar branch, spread over the row);
- the step's counters are summed (``substeps_max``: maximised) over the
  ranks in two all-reduces.

Transport follows the process group's backend: NCCL moves the device
tensors themselves (one rank per card).  Gloo takes no CUDA tensors in
point-to-point ops, so under gloo every slab, counter and gathered block is
staged through host memory explicitly; that is how several ranks share one
card.  The process group is the caller's (``init_distributed``, the
counterpart of ``jax.distributed.initialize``).

Under NCCL the drivers (``step_n``, ``step_n_buffered``, ``step_n_quiet``,
``step_jit``, so ``Simulation.run``) replay a CUDA graph of the sharded step
where the wrapped model is graphed, as the JAX package jits its
``shard_map``: the capture holds the kernels, the slab exchange and the
folds, the seam's all-gather and the two all-reduces of the counters
(``models/drivers.py`` says how the ranks capture together).  Under gloo
the step stages through host memory, and the drivers loop.

A layered model (``config.layers > 1``) is cut the same way: its planes
are ``[L, nx_b, ny_b]`` a rank, every layer shares the mesh, K4 deposits
every layer in one launch, each exchange moves all L layers' slabs in one
message a direction, and the counters ``[L, 10]`` and ``[L]`` reduce in the
same two all-reduces.  Per-layer winds (``LayeredWaveGrowth2D`` with
``per_layer_winds``) run on one device only.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..grids.base import Boundary, Grid2D
from ..models.drivers import StepDrivers
from ..models.state import ModelState2D, Particles2D
from ..ops import pic

log = logging.getLogger(__name__)

_PLANES = [f.name for f in dataclasses.fields(Particles2D)]
_GRID_PLANES = [f.name for f in dataclasses.fields(Grid2D) if f.name != "stats"]


def init_distributed(rank: int, world_size: int, backend: str,
                     port: int, host: str = "localhost",
                     timeout_s: float = 300.0) -> None:
    """Join the default process group over ``tcp://host:port``; every rank
    calls it with its own ``rank``.  Under NCCL each rank drives its own
    card: call ``torch.cuda.set_device`` first."""
    dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 2D mesh over the ranks of ``group`` (None: the default group):
    mesh rank ``r`` holds block ``(r // shape[1], r % shape[1])``."""

    shape: Tuple[int, int]
    group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    def coords(self, r: int) -> Tuple[int, int]:
        return divmod(r, self.shape[1])

    def rank_of(self, ix: int, iy: int) -> int:
        return ix * self.shape[1] + iy

    def global_rank(self, r: int) -> int:
        """The default group's rank of mesh rank ``r`` (point-to-point ops
        address peers by it)."""
        return r if self.group is None else dist.get_global_rank(self.group, r)


def make_mesh(shape: Optional[Tuple[int, int]] = None, group=None) -> Mesh:
    """A mesh over the initialised process group; defaults to all ranks in
    an (n, 1) layout."""
    n = dist.get_world_size(group)
    shape = (n, 1) if shape is None else (int(shape[0]), int(shape[1]))
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh {shape} needs {shape[0] * shape[1]} ranks, "
                         f"the group has {n}")
    return Mesh(shape, group)


def _ring_perm(n: int, wrap: bool, reverse: bool = False):
    """(source, destination) pairs that move slabs one step along a mesh
    axis: to the right neighbour (i -> i+1), or to the left one."""
    if reverse:
        perm = [(i, i - 1) for i in range(1, n)]
        if wrap and n > 0:
            perm.append((0, n - 1))
    else:
        perm = [(i, i + 1) for i in range(n - 1)]
        if wrap and n > 0:
            perm.append((n - 1, 0))
    return perm


def block_slices(shape: Tuple[int, int], nx: int, ny: int, ix: int, iy: int
                 ) -> Tuple[slice, slice]:
    """The x and y slices of block (ix, iy) of an ``[nx, ny]`` grid cut over
    a mesh of ``shape``."""
    bx, by = nx // shape[0], ny // shape[1]
    return slice(ix * bx, (ix + 1) * bx), slice(iy * by, (iy + 1) * by)


def slice_grid(grid: Grid2D, sx: slice, sy: slice) -> Grid2D:
    """The block's grid planes, contiguous; ``stats`` stay the global
    grid's (the counterpart of ``grid_specs``)."""
    return dataclasses.replace(
        grid, **{k: getattr(grid, k)[sx, sy].contiguous()
                 for k in _GRID_PLANES})


def slice_state(ms: ModelState2D, sx: slice, sy: slice, device
                ) -> ModelState2D:
    """The block of every plane of ``ms`` (its last two axes; the node
    state's two before the channels) on ``device``, contiguous; a layered
    state keeps its leading ``[L]``; the clock, iteration and counters
    whole (the counterpart of ``state_specs``)."""
    def cut(t):
        return t[..., sx, sy].to(device).contiguous()

    return ModelState2D(
        state=ms.state[..., sx, sy, :].to(device).contiguous(),
        particles=Particles2D(**{k: cut(getattr(ms.particles, k))
                                 for k in _PLANES}),
        time=ms.time.to(device), iteration=ms.iteration.to(device),
        metrics=type(ms.metrics)(*(getattr(ms.metrics, f.name).to(device)
                                   for f in dataclasses.fields(ms.metrics))))


class ShardedWaveGrowth2D(StepDrivers):
    """A ``WaveGrowth2D`` stepped block by block over ``mesh``; each rank
    holds its own block of the state.

    Usage (on every rank)::

        init_distributed(rank, world_size, "gloo", port)
        sharded = ShardedWaveGrowth2D(model, make_mesh((2, 2)))
        ms = sharded.init_state()       # this rank's block
        ms = sharded.step(ms)           # halo exchange inside
        whole = sharded.gather_state(ms)   # on rank 0, None elsewhere

    ``Simulation`` drives it as it drives the model: stores and checkpoints
    gather the blocks to rank 0, which writes them; ``pickup`` slices a
    whole checkpoint.
    """

    def __init__(self, model, mesh: Mesh):
        if not hasattr(model, "step_core"):
            raise TypeError(
                "ShardedWaveGrowth2D wraps a WaveGrowth2D model; for a "
                "LayeredWaveGrowth2D adapter pass its `.model` (layers "
                "shard with it when config.layers > 1). Per-layer winds are "
                "single-device only (each layer has its own model).")
        self.model = model
        # a layered model's planes are [L, nx_b, ny_b] a rank
        self.layers = model.config.layers
        self._layered = self.layers > 1
        self.mesh = mesh
        self.nx_dev, self.ny_dev = mesh.shape
        g = model.grid
        if g.nx % self.nx_dev or g.ny % self.ny_dev:
            raise ValueError(f"grid {g.nx}x{g.ny} not divisible by mesh "
                             f"{self.nx_dev}x{self.ny_dev}")
        self.halo = pic.normalize_halo(model.config.halo)
        (xl, xh), (yl, yh) = self.halo
        self.block = (g.nx // self.nx_dev, g.ny // self.ny_dev)
        if max(xl, xh) > self.block[0] or max(yl, yh) > self.block[1]:
            raise ValueError(
                f"halo {self.halo} is wider than the {self.block[0]}x"
                f"{self.block[1]} block: a slab would need two hops; use a "
                "coarser mesh")
        if dist.get_world_size(mesh.group) != mesh.size:
            raise ValueError(f"mesh {mesh.shape} over a group of "
                             f"{dist.get_world_size(mesh.group)} ranks")
        self.rank = dist.get_rank(mesh.group)
        self.ix, self.iy = mesh.coords(self.rank)
        self.backend = str(dist.get_backend(mesh.group))
        # gloo's point-to-point ops and gather take no CUDA tensors
        self._staged = self.backend == "gloo"
        self.transport = (f"{self.backend}, staged through host memory"
                          if self._staged else
                          f"{self.backend}, device tensors")
        # the drivers replay a CUDA graph of the step over NCCL
        # (models/drivers.py)
        self._graphed = self.backend == "nccl" and model.graphed
        self._kernel = model.resolved_config().scatter_mode == "dense_cuda"
        sx, sy = block_slices(mesh.shape, g.nx, g.ny, self.ix, self.iy)
        self._slices = (sx, sy)
        self.local_grid = slice_grid(g, sx, sy)
        # masks of the GLOBAL grid, sliced: a block's own edges are no
        # boundary
        self.local_active = model.active_mask[sx, sy].contiguous()
        self.local_boundary = model.boundary_mask[sx, sy].contiguous()
        self._seam_group = None
        if g.stats.by == Boundary.TRIPOLAR_NORTH and self.nx_dev > 1:
            # every process makes the group, in the same order
            self._seam_group = dist.new_group(
                [mesh.global_rank(mesh.rank_of(i, self.ny_dev - 1))
                 for i in range(self.nx_dev)])
        log.info("ShardedWaveGrowth2D: mesh %s, rank %d block (%d, %d), "
                 "transport %s", mesh.shape, self.rank, self.ix, self.iy,
                 self.transport)

    # -- the model's surface (Simulation drives it) -----------------------

    @property
    def settings(self):
        return self.model.settings

    @property
    def grid(self) -> Grid2D:
        """The global grid."""
        return self.model.grid

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def resolved_config(self):
        return self.model.resolved_config()

    def graph_keep(self) -> tuple:
        """The block's grid planes and masks, and the wrapped model's
        per-grid caches of them (``WaveGrowth2D.graph_keep``)."""
        return (self.local_grid, self.local_active, self.local_boundary,
                self.model.graph_keep())

    def capture_sync(self) -> None:
        """Every rank meets here between its warm-up and its capture."""
        self.barrier()

    def init_state(self) -> ModelState2D:
        """Every rank seeds the whole grid, as the model does (every layer
        of a layered model), and keeps its block (the counterpart of
        ``make_array_from_callback``)."""
        return self.shard_state(self.model.init_state_layers()
                                if self._layered else
                                self.model.init_state())

    def shard_state(self, ms: ModelState2D) -> ModelState2D:
        """This rank's block of a whole state, on the model's device."""
        return slice_state(ms, *self._slices, self.device)

    def step(self, ms: ModelState2D) -> ModelState2D:
        return self.model.step_core(ms, self.local_grid, self.local_active,
                                    self.local_boundary,
                                    self._scatter_sharded,
                                    self._reduce_counts)

    # -- transport -------------------------------------------------------

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return (t.to("cpu") if self._staged else t).contiguous()

    def _unwire(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self._staged else t

    def _shift(self, slab: torch.Tensor, axis: int, forward: bool,
               wrap: bool) -> Optional[torch.Tensor]:
        """``ppermute`` of ``slab`` one step along mesh axis ``axis`` (to the
        next block if ``forward``, else to the previous one): returns the
        slab this block receives, or None where no block sends to it (an
        open axis' edge).  The send and the receive of one shift are one
        batch, so on a ring of two, where both neighbours are one rank, the
        two shifts of an axis never interleave."""
        n = self.mesh.shape[axis]
        i = (self.ix, self.iy)[axis]
        if n == 1:
            return slab if wrap else None
        perm = _ring_perm(n, wrap, reverse=not forward)
        dst = [d for s, d in perm if s == i]
        src = [s for s, d in perm if d == i]

        def peer(j):
            c = [self.ix, self.iy]
            c[axis] = j
            return self.mesh.global_rank(self.mesh.rank_of(*c))

        ops, buf = [], None
        if dst:
            ops.append(dist.P2POp(dist.isend, self._wire(slab), peer(dst[0]),
                                  self.mesh.group))
        if src:
            buf = torch.empty(slab.shape, dtype=slab.dtype,
                              device="cpu" if self._staged else slab.device)
            ops.append(dist.P2POp(dist.irecv, buf, peer(src[0]),
                                  self.mesh.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return None if buf is None else self._unwire(buf)

    def _reduce_counts(self, counts: torch.Tensor, smax: torch.Tensor):
        """The packed counters (``[10]``, or ``[L, 10]`` layered) summed and
        ``substeps_max`` (0-dim or ``[L]``) maximised over the ranks, every
        layer in the same two all-reduces."""
        c, m = self._wire(counts), self._wire(smax)
        dist.all_reduce(c, op=dist.ReduceOp.SUM, group=self.mesh.group)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.mesh.group)
        return self._unwire(c), self._unwire(m)

    # -- the deposit -----------------------------------------------------

    def accumulate_padded(self, xrel, yrel, chans, act):
        """The block's padded accumulator ``[3, nx_b+xl+xh, ny_b+yl+yh]``
        (``[3, L, ...]`` layered) and its clamped count: K4 under
        ``scatter_mode="dense_cuda"``, otherwise its plain version."""
        if self._kernel:
            from ..ops.pic_cuda import pic_gather_padded

            return pic_gather_padded(xrel, yrel, chans, act, self.halo)
        P, st = pic.scatter_accumulate_padded(
            xrel, yrel, torch.stack(chans, dim=-1), act, self.halo)
        return P.movedim(-1, 0), st

    def _scatter_sharded(self, xrel, yrel, chans, act):
        """Local deposit, halo exchange and boundary folds; returns the
        block's three node planes and the local clamped count.  The low
        slab (width x_lo) belongs to the previous block's tail, the high
        one (x_hi) to the next block's head.  The planes are the block's
        last two axes; a layered block's slabs carry every layer, so each
        direction is one message."""
        (xl, xh), (yl, yh) = self.halo
        st = self.model.grid.stats
        P, stats = self.accumulate_padded(xrel, yrel, chans, act)
        nxl, nyl = xrel.shape[-2:]

        # x, on the padded planes' full y extent
        wrap_x = st.bx in (Boundary.PERIODIC, Boundary.TRIPOLAR_NORTH)
        Q = P[..., xl:xl + nxl, :]
        if xl:
            r = self._shift(P[..., :xl, :], 0, False, wrap_x)
            if r is not None:
                Q[..., nxl - xl:, :] += r
        if xh:
            r = self._shift(P[..., xl + nxl:, :], 0, True, wrap_x)
            if r is not None:
                Q[..., :xh, :] += r

        # y, on the x-folded rows, corners included
        wrap_y = st.by == Boundary.PERIODIC
        S = Q[..., yl:yl + nyl]
        top = Q[..., yl + nyl:]
        if yl:
            r = self._shift(Q[..., :yl], 1, False, wrap_y)
            if r is not None:
                S[..., nyl - yl:] += r
        if yh:
            r = self._shift(top, 1, True, wrap_y)
            if r is not None:
                S[..., :yh] += r
        if st.by == Boundary.TRIPOLAR_NORTH and self.iy == self.ny_dev - 1:
            self._fold_seam(S, top)
        return tuple(S[c].contiguous() for c in range(S.shape[0])), stats

    def _fold_seam(self, S, top) -> None:
        """Tripolar north fold over the top row of blocks: the whole top
        halo, gathered along x, flipped (x' = nx - 2 - x mod nx) and each
        block's slice added onto its top rows."""
        if self._seam_group is None:
            full = top
        else:
            w = self._wire(top)
            parts = [torch.empty_like(w) for _ in range(self.nx_dev)]
            dist.all_gather(parts, w, group=self._seam_group)
            full = self._unwire(torch.cat(parts, dim=-2))
        nxl, nyl = S.shape[-2:]
        x0 = self.ix * nxl
        for k in range(top.shape[-1]):
            row = full[..., k]
            folded = torch.roll(torch.flip(row, dims=(-1,)), -1, dims=-1)
            S[..., nyl - 1 - k] += folded[..., x0:x0 + nxl]

    # -- whole fields on rank 0 ------------------------------------------

    def gather_blocks(self, t: torch.Tensor, axis: int = 0
                      ) -> Optional[torch.Tensor]:
        """``t``, a block's tensor whose dims ``axis`` and ``axis + 1`` are
        the block's x and y, whole on rank 0 (on the model's device); None
        on the other ranks.  A layered model's tensors carry the layer axis
        just before x, which ``axis`` does not count.  A collective: every
        rank calls it."""
        axis += int(self._layered)
        w = self._wire(t)
        parts: Optional[List[torch.Tensor]] = (
            [torch.empty_like(w) for _ in range(self.mesh.size)]
            if self.is_root else None)
        dist.gather(w, parts, dst=self.mesh.global_rank(0),
                    group=self.mesh.group)
        if parts is None:
            return None
        rows = [torch.cat([parts[self.mesh.rank_of(i, j)]
                           for j in range(self.ny_dev)], dim=axis + 1)
                for i in range(self.nx_dev)]
        return self._unwire(torch.cat(rows, dim=axis))

    def gather_state(self, ms: ModelState2D) -> Optional[ModelState2D]:
        """The whole state on rank 0 (None elsewhere), for stores and
        checkpoints."""
        state = self.gather_blocks(ms.state)
        planes = {k: self.gather_blocks(getattr(ms.particles, k))
                  for k in _PLANES}
        if not self.is_root:
            return None
        return dataclasses.replace(ms, state=state,
                                   particles=Particles2D(**planes))

    def any_rank(self, flag: bool) -> bool:
        """True on every rank if ``flag`` is true on any."""
        t = torch.tensor([int(flag)], dtype=torch.int32,
                         device="cpu" if self._staged else self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.group)
        return bool(t.item())

    def barrier(self) -> None:
        if self.backend == "nccl":
            idx = self.device.index
            dist.barrier(group=self.mesh.group, device_ids=[
                torch.cuda.current_device() if idx is None else idx])
        else:
            dist.barrier(group=self.mesh.group)

    def save_checkpoint(self, path: str, ms: ModelState2D) -> str:
        """Rank 0 writes the whole state in the single-device layout (so it
        resumes in a single-device run of either package); every rank
        returns the path once the file is complete."""
        from ..simulation.checkpoint import npz_path, save_checkpoint

        whole = self.gather_state(ms)
        if whole is not None:
            save_checkpoint(path, whole)
        self.barrier()
        return npz_path(path)

    def load_checkpoint(self, path: str) -> ModelState2D:
        """Every rank reads the whole checkpoint and keeps its block."""
        from ..simulation.checkpoint import load_checkpoint

        return self.shard_state(load_checkpoint(path, device="cpu"))
