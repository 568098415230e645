"""Nothing under benchmark/ imports JAX or the JAX package (top-level
module names compared whole), and the plain reference imports nothing
of the port."""
import ast
import glob
import os

from benchmark.harness import common

FORBIDDEN = {"jax", "jaxlib", "flax", "fast_nnunet_tpu"}


def imports(path):
    """Top-level names of every module the file imports (relative imports
    as '.')."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("." if node.level else node.module.split(".")[0])
    return out


def files(*parts):
    return glob.glob(os.path.join(common.HERE, *parts), recursive=True)


def test_no_jax_anywhere():
    for path in files("**", "*.py"):
        found = imports(path) & FORBIDDEN
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_port():
    for path in files("reference", "*.py") + [
            os.path.join(common.HERE, "harness", "grid.py")]:
        assert "fast_nnunet_tpu_torch" not in imports(path), path
    # the reference's relative imports reach only itself and grid.py
    for path in files("reference", "*.py"):
        with open(path) as f:
            src = f.read()
        for line in src.splitlines():
            if line.startswith("from .."):
                assert line.startswith("from ..harness import grid"), line


def test_forbidden_modules_compares_whole_names():
    assert common.forbidden_modules(
        ["fast_nnunet_tpu_torch.ops", "jaxtyping", "jax.numpy",
         "fast_nnunet_tpu.models", "flaxen", "numpy"]) == \
        ["fast_nnunet_tpu", "jax"]
