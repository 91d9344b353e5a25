"""The port stands alone: no file under robosimgs_tpu_torch/ imports JAX,
its relatives, or the JAX package, nor OpenCV or msgpack, which a GPU
host may not have; Pillow, which it may not have either, is imported by
no module at module level and nowhere on the policy and articulation
paths."""

import ast
from pathlib import Path

import jax  # noqa: F401  (tests import both packages)

import robosimgs_tpu_torch

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "robosimgs_tpu", "cv2",
             "msgpack"}


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_port_imports_no_jax_and_no_jax_package():
    root = Path(robosimgs_tpu_torch.__file__).parent
    files = sorted(root.rglob("*.py"))
    assert len(files) > 10
    bad = [f"{f.relative_to(root)}:{line} imports {mod}"
           for f in files
           for mod, line in _imported_roots(ast.parse(f.read_text()))
           if mod in FORBIDDEN]
    assert not bad, bad


def test_chip_smoke_imports_no_jax():
    script = Path(robosimgs_tpu_torch.__file__).parents[1] / "chip_smoke.py"
    bad = [f"chip_smoke.py:{line} imports {mod}"
           for mod, line in _imported_roots(ast.parse(script.read_text()))
           if mod in FORBIDDEN]
    assert not bad, bad


def test_no_pillow_at_module_level_nor_on_the_policy_path():
    root = Path(robosimgs_tpu_torch.__file__).parent
    bad = []
    for f in sorted(root.rglob("*.py")):
        rel = f.relative_to(root).as_posix()
        tree = ast.parse(f.read_text())
        on_path = rel.startswith(("policy/", "artic/")) or rel in (
            "cli/train_policy.py", "utils/imresize.py", "utils/bake.py",
            "utils/pointcloud.py", "cli/estimate_physics.py",
            "cli/visualize_parts.py", "cli/validate_urdf.py",
            "cli/articulate.py", "utils/morphology.py")
        top = {n.lineno for n in tree.body}      # module-level statements
        bad += [f"{rel}:{line} imports PIL"
                for mod, line in _imported_roots(tree)
                if mod == "PIL" and (on_path or line in top)]
    assert not bad, bad
