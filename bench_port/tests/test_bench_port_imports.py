"""No module of the benchmark imports JAX or the JAX package, and no module
of the reference imports the program: every import's top-level name,
compared whole (``pion_tpu_torch`` begins with ``pion_tpu``)."""
import ast
import os

from bench_port import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "pion_tpu"}
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def imported_tops(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in
                ("import_module", "__import__") and node.args
                and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def modules(under: str):
    for d, _, files in os.walk(under):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    bad = {p: imported_tops(p) & FORBIDDEN for p in modules(HERE)}
    assert not {p: b for p, b in bad.items() if b}


def packages(under: str) -> list:
    return sorted(d for d in os.listdir(under)
                  if os.path.isfile(os.path.join(under, d, "__init__.py")))


def test_reference_imports_no_program():
    """Every reference package under ``reference/`` (each a configuration
    may name), the comparison beside them, and every builder under
    ``builders/`` (which makes the inputs both sides get)."""
    ref = os.path.join(HERE, "reference")
    assert "port_plain" in packages(ref)
    paths = [os.path.join(ref, "compare.py")]
    for pkg in packages(ref):
        paths += modules(os.path.join(ref, pkg))
    paths += modules(os.path.join(HERE, "builders"))
    bad = {p: imported_tops(p) & (FORBIDDEN | {"pion_tpu_torch"})
           for p in paths}
    assert not {p: b for p, b in bad.items() if b}


def test_guard_compares_whole_names():
    assert harness.foreign_modules(["pion_tpu_torch.sim", "torch"]) == []
    assert harness.foreign_modules(["pion_tpu.sim", "jax.numpy",
                                    "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "pion_tpu"]


def test_walker_sees_a_planted_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom pion_tpu.sim import x\n"
                 "import importlib\nimportlib.import_module('jax.numpy')\n")
    assert imported_tops(str(p)) & FORBIDDEN == {"pion_tpu", "jax"}
