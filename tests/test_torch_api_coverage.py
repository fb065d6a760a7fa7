"""Every top-level name of the JAX package has a counterpart in the port.

The test walks both packages' module trees with ``ast`` (no import): for
each module ``picles_tpu/<path>`` it reads the names its top level defines
or assigns (and a package's ``__init__.py`` its public imports), and
asserts that ``picles_torch/<path>`` defines, assigns or imports each of
them, apart from the names listed once in ``OTHER_NAMES`` below: each
with the port's counterpart under another name or in another file (checked
to exist), or with the reason it has none.  It also holds that the list
names nothing the port now has under the same name, that the package
imports none of the JAX stack or the optional I/O libraries at module
level, and that it imports with pandas and tensorstore missing.
"""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU = os.path.join(REPO, "picles_tpu")
TORCH = os.path.join(REPO, "picles_torch")

# (module of picles_tpu, name) -> (the port's counterpart as
# "path:name" under picles_torch/, or None; the reason)
OTHER_NAMES = {
    # the Pallas kernels and their launchers: CUDA kernels and their
    # wrappers (K1-K6)
    ("ops/advance_pallas.py", "_advance_kernel"):
        ("csrc/advance.cu:advance_kernel", "K1, a CUDA kernel"),
    ("ops/advance_pallas.py", "_auto_dt_kernel"):
        ("csrc/advance.cu:auto_dt_kernel", "K3, a CUDA kernel"),
    ("ops/advance_pallas.py", "advance_pallas"):
        ("ops/advance_cuda.py:advance_cuda", "K1's launcher"),
    ("ops/advance_pallas.py", "auto_dt_pallas"):
        ("ops/advance_cuda.py:auto_dt_cuda", "K3's launcher"),
    ("ops/advance_pallas.py", "PallasAdvanceResult"):
        ("ops/advance_cuda.py:AdvanceResult", "K1's outputs"),
    ("ops/pic_pallas.py", "_accum_kernel"):
        ("csrc/pic_gather.cu:pic_gather_tiled_kernel",
         "K2 and K4, one CUDA kernel"),
    ("ops/pic_pallas.py", "_accum_remesh_kernel"):
        ("csrc/pic_gather.cu:pic_gather_remesh_tiled_kernel",
         "K6, a CUDA kernel"),
    ("ops/pic_pallas.py", "_gather_accumulate"):
        ("csrc/pic_gather.cu:sum_chunk", "the window sum of K2, K4, K6"),
    ("ops/pic_pallas.py", "_gather_setup"):
        ("ops/pic_cuda.py:_gather_setup", "the gather's inputs"),
    ("ops/pic_pallas.py", "_check_halo_fits"):
        ("ops/pic_cuda.py:_deposit_setup", "the halo check"),
    ("ops/pic_pallas.py", "_best_block_y"):
        (None, "TPU block sizing to VMEM; the CUDA tiling is compiled in"),
    ("ops/pic_pallas.py", "_window_spec"):
        (None, "a Pallas BlockSpec; CUDA blocks index the window"),
    ("ops/pic_pallas.py", "scatter_core_channels_pallas"):
        ("ops/pic_cuda.py:pic_gather", "K2's launcher"),
    ("ops/pic_pallas.py", "scatter_padded_channels_pallas"):
        ("ops/pic_cuda.py:pic_gather_padded", "K4's launcher"),
    ("ops/pic_pallas.py", "scatter_accumulate_padded_pallas"):
        ("ops/pic_cuda.py:pic_gather_padded",
         "K4 on a stacked charge; the sharded step stacks nothing"),
    ("ops/pic_pallas.py", "scatter_remesh_fused"):
        ("ops/pic_cuda.py:pic_gather_remesh", "K6's launcher"),
    ("ops/remesh_pallas.py", "_remesh_kernel"):
        ("csrc/remesh.cu:remesh_kernel", "K5, a CUDA kernel"),
    ("ops/remesh_pallas.py", "remesh_pallas"):
        ("ops/remesh_cuda.py:remesh_cuda", "K5's launcher"),
    ("ops/remesh_pallas.py", "remesh_core"):
        ("ops/remesh.py:remesh_core", "the plain remesh, in its own module"),
    ("ops/remesh_pallas.py", "RemeshResult"):
        ("ops/remesh.py:RemeshResult", "the plain remesh's outputs"),
    ("ops/remesh_pallas.py", "GATHER_BIT"):
        ("ops/remesh.py:GATHER_BIT", "a remesh branch bit"),
    ("ops/remesh_pallas.py", "RESEED_BIT"):
        ("ops/remesh.py:RESEED_BIT", "a remesh branch bit"),
    ("ops/remesh_pallas.py", "OFF_BIT"):
        ("ops/remesh.py:OFF_BIT", "a remesh branch bit"),
    # TPU block sizing: not ported (ROADMAP section 2, "Do not port")
    **{("ops/pallas_util.py", n): (None, "TPU block sizing to VMEM and "
                                   "(8, 128) tiles")
       for n in ("auto_block_x", "col_block", "fits_row_tiling", "pad_cols",
                 "pad_rows", "row_block")},
    # counterparts by another name
    ("parallel/sharded.py", "grid_specs"):
        ("parallel/sharded.py:slice_grid",
         "shard_map's PartitionSpecs of a grid: the port slices each block"),
    ("parallel/sharded.py", "state_specs"):
        ("parallel/sharded.py:slice_state",
         "shard_map's PartitionSpecs of a state: the port slices each block"),
    ("forcing/winds.py", "gridded_pallas_samplers"):
        ("csrc/rhs.cuh:GriddedWind",
         "the kernels' samplers of a gridded wind's step planes (the plain "
         "versions' are forcing/winds.py pwl_winds)"),
    ("models/wave_growth_2d.py", "_resolve_auto_modes"):
        ("models/wave_growth_2d.py:resolve_modes",
         "the port resolves 'auto' by the grid's device"),
    ("simulation/store.py", "h5py"):
        (None, "the JAX module binds h5py (or None) at import; the port "
         "imports it inside StateStore, as the card machine has none"),
    ("simulation/checkpoint.py", "_template"):
        ("simulation/checkpoint.py:_KINDS",
         "the state classes of each checkpoint kind"),
}

# modules the package, chip_smoke.py and their module-level imports never
# reach: the JAX stack, and I/O libraries the card machine lacks
BANNED = ("jax", "jaxlib", "picles_tpu", "orbax", "pandas", "tensorstore")


def _modules(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(d, f)
                out[os.path.relpath(p, root).replace(os.sep, "/")] = p
    return out


def _top_names(path, imports=True):
    """Names a module's top level defines or assigns, and (``imports``)
    imports, also under a module-level ``if`` or ``try``."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()

    def visit(body):
        for n in body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                names.add(n.name)
            elif isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                for t in targets:
                    for e in ast.walk(t):
                        if isinstance(e, ast.Name):
                            names.add(e.id)
            elif isinstance(n, (ast.Import, ast.ImportFrom)) and imports:
                for a in n.names:
                    names.add((a.asname or a.name).split(".")[0])
            elif isinstance(n, (ast.If, ast.Try)):
                visit(n.body)
                visit(getattr(n, "orelse", []))
                for h in getattr(n, "handlers", []):
                    visit(h.body)
    visit(tree.body)
    return names


def _exists(ref):
    path, name = ref.split(":")
    full = os.path.join(TORCH, path)
    if not os.path.exists(full):
        return False
    if path.endswith(".py"):
        return name in _top_names(full)
    with open(full) as f:
        return name in f.read()


def _jax_names(rel, path):
    """What a JAX module makes: its definitions and assignments, and for a
    package's ``__init__.py`` the public names it imports (its API)."""
    names = _top_names(path, imports=False)
    if rel.endswith("__init__.py"):
        names |= {n for n in _top_names(path) if not n.startswith("_")
                  and n not in ("annotations",) + BANNED}
    return names


def _missing():
    """(module, name) of picles_tpu without the same name (defined,
    assigned or imported) in the port's module of the same path."""
    tpu, torch_mods = _modules(TPU), _modules(TORCH)
    out = []
    for rel, path in sorted(tpu.items()):
        have = _top_names(torch_mods[rel]) if rel in torch_mods else set()
        for name in sorted(_jax_names(rel, path) - have):
            out.append((rel, name))
    return out


def test_every_jax_name_has_a_counterpart():
    left = [m for m in _missing() if m not in OTHER_NAMES]
    assert not left, f"picles_tpu names with no counterpart: {left}"


@pytest.mark.parametrize("key", sorted(OTHER_NAMES))
def test_documented_counterpart_exists(key):
    """Each documented entry is still missing under its own name (else
    the list is stale), and its counterpart exists."""
    assert key in _missing(), f"{key} is in the port now: drop the entry"
    ref, reason = OTHER_NAMES[key]
    assert reason
    if ref is not None:
        assert _exists(ref), f"{key}: no {ref} in picles_torch"


def test_version():
    import picles_tpu
    import picles_torch

    assert picles_torch.__version__ == picles_tpu.__version__


def _module_level_imports(path):
    """Top-level module names imported outside any function or class."""
    with open(path) as f:
        tree = ast.parse(f.read())
    found = set()

    def visit(node):
        for n in ast.iter_child_nodes(node):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            if isinstance(n, ast.Import):
                found.update(a.name.split(".")[0] for a in n.names)
            elif isinstance(n, ast.ImportFrom) and n.level == 0 and n.module:
                found.add(n.module.split(".")[0])
            visit(n)
    visit(tree)
    return found


def test_no_module_level_import_of_the_jax_stack_or_optional_io():
    files = list(_modules(TORCH).values()) + [os.path.join(REPO,
                                                           "chip_smoke.py")]
    bad = {os.path.relpath(p, REPO): sorted(_module_level_imports(p)
                                            & set(BANNED))
           for p in files}
    assert not {k: v for k, v in bad.items() if v}, bad


def test_imports_without_pandas_and_tensorstore():
    """``import picles_torch`` and every module of it with pandas,
    tensorstore and the JAX stack unimportable; the dataframe converters
    and the orbax backend then raise ImportError when called."""
    code = (
        "import sys\n"
        f"for m in {BANNED!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, picles_torch\n"
        "for m in pkgutil.walk_packages(picles_torch.__path__, "
        "'picles_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from picles_torch.utils import particle_tools as PT\n"
        "import numpy as np\n"
        "try:\n"
        "    PT.particle_to_dataframe(np.zeros((2, 1, 5)), np.zeros((2, 1)),"
        " (0,))\n"
        "except ImportError:\n"
        "    print('pandas refused')\n"
        "from picles_torch.simulation.checkpoint import _tensorstore\n"
        "try:\n"
        "    _tensorstore()\n"
        "except ImportError as e:\n"
        "    assert 'tensorstore' in str(e)\n"
        "    print('tensorstore refused')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["pandas", "refused", "tensorstore",
                                  "refused"]
