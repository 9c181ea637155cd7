"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest bench/tests`` from the repository's root; the card's
tests carry the ``gpu`` marker and skip without one)."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a size the CPU runs in seconds: the same files, shrunk
TINY_CONFIG = dict(rows=4096, M=4, M0=8, ef_construction=16, ef_search=16)
TINY_D = {"sift128": 16, "glove100": 12}


def shrink(root: Path) -> None:
    """Shrink every configuration and mix of a copy to the tiny size."""
    for p in (root / "bench" / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        cfg.update(TINY_CONFIG, d=TINY_D.get(p.stem, 16))
        p.write_text(json.dumps(cfg))
    for p in (root / "bench" / "traffic").glob("*.json"):
        tr = json.loads(p.read_text())
        if tr["loop"] == "closed":
            tr.update(batch=64, pool_batches=3)
        else:
            tr.update(query_rate=400, query_pool=500, standing_ops=128)
            tr["engine"].update(max_batch=64, max_ops_per_drain=128)
        p.write_text(json.dumps(tr))


def copy_bench(dst: Path) -> Path:
    shutil.copytree(ROOT / "bench", dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    return dst


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of the benchmark's files at the tiny size."""
    root = copy_bench(tmp_path)
    shrink(root)
    return root


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
