"""The PyTorch port stands alone: no file of `dragonboat_tpu_torch/`, and
neither `chip_smoke.py` nor `compare_kernels.py`, nor the Python glue that
the port's embedding ABI (`dragonboat_tpu_torch/native/binding.cc`) loads
into its interpreter, imports jax or the JAX package `dragonboat_tpu`."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "dragonboat_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "compare_kernels.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "dragonboat_tpu_torch")):
        files += [os.path.join(d, n) for n in sorted(names) if n.endswith(".py")]
    return sorted(files)


GLUE = os.path.join(ROOT, "dragonboat_tpu_torch", "native", "binding.cc")


def _glue_source():
    """The Python glue string of the port's binding.cc."""
    src = open(GLUE).read()
    a = src.index('R"PY(') + len('R"PY(')
    return src[a:src.index(')PY"', a)]


def _imported_roots(path, source=None):
    tree = ast.parse(open(path).read() if source is None else source, filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_file_imports_no_jax(path):
    bad = [(m, line) for m, line in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_embedding_glue_imports_no_jax():
    roots = [m for m, _ in _imported_roots(GLUE, _glue_source())]
    assert "dragonboat_tpu_torch" in roots
    bad = [m for m in roots if m in FORBIDDEN]
    assert not bad, f"the embedding glue imports {bad}"
    assert "jax" not in _glue_source().lower()


def test_scan_sees_the_port():
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert "chip_smoke.py" in files and "compare_kernels.py" in files
    assert os.path.join("dragonboat_tpu_torch", "ops", "kernel.py") in files
    assert os.path.join("dragonboat_tpu_torch", "ops", "loopback.py") in files


def test_scan_catches_a_jax_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom jax import numpy\nimport dragonboat_tpu.ops\n")
    assert [m for m, _ in _imported_roots(str(p))] == ["os", "jax", "dragonboat_tpu"]
