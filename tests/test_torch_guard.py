"""The port stands alone: no module of gpnf_tpu_torch/, and not
chip_smoke.py, imports jax or anything of the JAX package gpnf_tpu."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "gpnf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "gpnf_tpu")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imports(ast.parse(path.read_text(), str(path)))
           if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_guard_sees_the_whole_port():
    assert (ROOT / "chip_smoke.py").exists()
    names = {p.name for p in FILES}
    assert {"marscf.py", "fused_attention.py", "convert.py",
            "eval_marscf.py", "gp.py", "fused_coupling.py", "cholesky.py",
            "trisolve.py", "train_gp.py", "bench_flow_gp.py"} <= names
    assert _forbidden("jax.numpy") and _forbidden("gpnf_tpu.ops")
    assert not _forbidden("gpnf_tpu_torch.ops")
