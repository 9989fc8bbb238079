"""No file of the benchmark imports JAX or the JAX package, and the
references import nothing of the program: top-level module names
compared whole (the port's name begins with the JAX package's)."""
import ast

from wfbench_testlib import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "windflow_tpu"}
PROGRAM = "windflow_tpu_torch"


def _imports(path):
    """Top-level names of every absolute import in ``path``, and of the
    string given to importlib.import_module / __import__."""
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            fn = node.func
            fname = getattr(fn, "attr", None) or getattr(fn, "id", None)
            if fname in ("import_module", "__import__"):
                names.add(node.args[0].value.split(".")[0])
    return names


def test_wfbench_imports_no_jax_nor_the_jax_package():
    files = sorted((ROOT / "wfbench").rglob("*.py"))
    assert len(files) > 10
    bad = {str(p): sorted(_imports(p) & FORBIDDEN) for p in files}
    assert not {p: n for p, n in bad.items() if n}


def test_wfbench_references_import_nothing_of_the_program():
    files = sorted((ROOT / "wfbench" / "reference").glob("*.py"))
    assert files
    for p in files:
        names = _imports(p)
        assert PROGRAM not in names and not names & FORBIDDEN, p
        assert names <= {"__future__", "numpy"}, (p, names)


def test_wfbench_import_check_compares_whole_names(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import windflow_tpu_torch.ops\nfrom jaxlib import x\n"
                 "import importlib\nimportlib.import_module('flax.core')\n")
    assert _imports(p) & FORBIDDEN == {"jaxlib", "flax"}
