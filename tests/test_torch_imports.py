"""The port and chip_smoke.py import neither JAX nor the reference package."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "flax", "optax")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


PORTED = ["core/maintenance.py", "api/facade.py", "api/__init__.py",
          "serving/metrics.py", "serving/snapshot.py", "serving/batcher.py",
          "serving/update_queue.py", "serving/engine.py",
          "serving/__init__.py", "launch/serve.py", "kernels/_build.py",
          "core/distributed.py", "launch/mesh.py", "configs/__init__.py",
          "configs/base.py", "configs/stablelm_1_6b.py",
          "configs/wide_deep.py", "data/pipeline.py", "data/synthetic.py",
          "models/__init__.py", "models/_params.py", "models/convert.py",
          "models/modules.py", "models/recsys.py", "models/transformer.py",
          "models/api.py", "train/__init__.py", "train/optimizer.py",
          "train/compress.py", "train/checkpoint.py", "launch/train.py",
          "_tree.py", "models/dist_ctx.py", "models/e3.py",
          "models/nequip.py", "models/gnn_common.py", "models/_scope.py",
          "launch/dryrun.py"]
KERNELS = ["topk_dist", "l2dist", "embed_bag"]


def test_port_files_found():
    assert len(FILES) > 40
    pkg = ROOT / "src" / "repro_torch"
    for rel in PORTED:
        assert pkg / rel in FILES, rel
    for name in KERNELS:
        for rel in ("ref.py", f"{name}.py", "ops.py", "__init__.py"):
            assert pkg / "kernels" / name / rel in FILES, (name, rel)
        assert (pkg / "kernels" / name / "csrc" / f"{name}.cu").exists()


@pytest.mark.parametrize("name", KERNELS)
def test_cuda_sources_name_the_kernel_they_replace(name):
    src = (ROOT / "src" / "repro_torch" / "kernels" / name / "csrc"
           / f"{name}.cu").read_text()
    head = src.split("#include")[0]
    assert f"repro/kernels/{name}/{name}.py::" in head.replace("\n// ", "")
    assert "bound" in head and "Design" in head


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"
