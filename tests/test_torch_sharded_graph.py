"""The sharded step's capture rule and its host traffic, on the CPU, over a
one-rank gloo group in this process.

On the card ``ShardedWaveGrowth2D`` over NCCL replays a CUDA graph of its
step (``models/drivers.py``); over gloo it stages every message through
host memory and its drivers loop.  Here:

- ``graphed`` is false under gloo, even where the wrapped model is graphed,
  and the drivers then loop (no capture, the steps equal ``step`` in a
  loop); ``graph_keep`` holds the block's grid planes and masks;
- the sharded step's own code (the padded deposit, the slab exchange and
  folds, the counters' all-reduces, on the flagship box and the default
  configuration at 16^2) makes no transfer between host and device but
  gloo's staging (``_wire``, ``_unwire``), under the ``HostTraffic`` guard
  of tests/test_torch_graphs.py, which also excepts the plain advance and
  dt reset (kernels K1 and K3 on the card).

The (1, 1) NCCL step graphed against its eager steps runs on the card
(tests/test_torch_cuda.py, marker ``cuda``).
"""

import socket
import sys

import pytest
import torch
import torch.distributed as dist

from picles_torch.parallel import sharded as tsh
from test_torch_graphs import HostTraffic, _model

torch.set_num_threads(1)

STAGING = {tsh.ShardedWaveGrowth2D._wire.__code__,
           tsh.ShardedWaveGrowth2D._unwire.__code__}


class StepTraffic(HostTraffic):
    """``HostTraffic`` that also excepts gloo's staging through host
    memory."""

    def record(self, what: str) -> None:
        f = sys._getframe(1)
        while f is not None:
            if f.f_code in STAGING:
                return
            f = f.f_back
        super().record(what)


@pytest.fixture(scope="module")
def mesh():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tsh.init_distributed(0, 1, "gloo", port, timeout_s=60.0)
    yield tsh.make_mesh((1, 1))
    dist.destroy_process_group()


@pytest.mark.parametrize("path", ["pallas", "default"])
def test_gloo_sharded_step_is_not_graphed_and_loops(mesh, path):
    model = _model(path)
    sh = tsh.ShardedWaveGrowth2D(model, mesh)
    assert sh.transport == "gloo, staged through host memory"
    assert sh.graphed is False
    with pytest.raises(AttributeError):
        sh.graphed = True
    keep = sh.graph_keep()
    assert keep[0] is sh.local_grid and keep[1] is sh.local_active \
        and keep[2] is sh.local_boundary
    ms = sh.init_state()
    a = sh.step_n_quiet(ms, 2)
    assert sh._graph is None
    b = sh.step(sh.step(ms))
    for x, y in zip(a.leaves(), b.leaves()):
        assert torch.equal(x, y)
    # a graphed wrapped model does not make the gloo step graphed
    model._graphed = True
    assert tsh.ShardedWaveGrowth2D(model, mesh).graphed is False


@pytest.mark.parametrize("path", ["xla", "pallas", "default"])
def test_sharded_step_makes_no_host_transfer_but_gloo_staging(mesh, path):
    sh = tsh.ShardedWaveGrowth2D(_model(path), mesh)
    ms = sh.step(sh.init_state())
    with StepTraffic() as seen:
        ms = sh.step(ms)
    assert seen.seen == [], seen.seen
    assert int(ms.iteration) == 2 and int(ms.metrics.n_failed) == 0
    # the staging itself is seen by the plain guard
    with HostTraffic() as seen:
        sh.step(ms)
    assert ("to(cpu)" in [w for w, _ in seen.seen])
