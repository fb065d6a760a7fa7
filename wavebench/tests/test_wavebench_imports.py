"""No module of the benchmark imports JAX or the port's JAX reference
package (compared by whole top-level name), the plain reference imports
nothing of the port, and a run that holds them is caught."""

import ast

from wavebench.harness import HERE, FORBIDDEN, forbidden_modules


def imported(path) -> set:
    """The top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = imported(f) & set(FORBIDDEN)
        assert not bad, f"{f.relative_to(HERE)} imports {bad}"


def test_the_reference_imports_nothing_of_the_port():
    for name in ("reference.py", "generator.py", "roofline.py", "stats.py"):
        got = imported(HERE / name)
        assert "picles_torch" not in got, name
        assert got <= {"__future__", "dataclasses", "math", "typing",
                       "numpy", "torch", "statistics"}, (name, got)


def test_forcing_kinds_import_nothing_of_the_port():
    """A kind's plain wind is the reference's: it names the port's wind only
    through the package handed to ``Wind.port``."""
    files = sorted((HERE / "forcing").glob("*.py"))
    assert files
    for f in files:
        got = imported(f)
        assert "picles_torch" not in got, f.name
        assert got <= {"__future__", "math", "numpy", "torch",
                       "wavebench"}, (f.name, got)


def test_top_level_names_are_compared_whole():
    assert forbidden_modules({"picles_torch", "picles_torch.ops",
                              "jaxtyping", "flaxen", "torch"}) == []
    assert forbidden_modules({"jax.numpy", "picles_tpu.ops",
                              "torch"}) == ["jax", "picles_tpu"]
