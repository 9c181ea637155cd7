"""What the harness, the loops and the scripts share: files found by name,
the configuration's index, and a device sync.

A part of the benchmark that a later mix, configuration or metric may
replace is a file of its own, found by the name a manifest or mix file
gives it (``load_file(root, "loops", "open")`` is
``bench/loops/open.py``); adding one needs no edit of a file that is
there.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(root: Path, kind: str, name: str):
    """The module ``bench/<kind>/<name>.py`` of the checkout at ``root``,
    loaded once per process (a second call returns the same module)."""
    if not _NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = (Path(root) / "bench" / kind / f"{name}.py").resolve()
    if not path.is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
    key = "bench_file_" + re.sub(r"[^A-Za-z0-9_]", "_", str(path))
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def make_index(cfg: dict, seed: int, device):
    """The configuration's empty ``VectorIndex``, capacity = its rows."""
    import torch
    from repro_torch import api

    from .reference import data as D
    return api.VectorIndex(
        space=cfg["space"], dim=cfg["d"], capacity=cfg["rows"], M=cfg["M"],
        M0=cfg["M0"], num_layers=cfg["num_layers"],
        ef_construction=cfg["ef_construction"], ef_search=cfg["ef_search"],
        strategy=cfg["strategy"], seed=D.stream_seed(seed, D.INDEX) % (1 << 31),
        dtype=getattr(torch, cfg["dtype"]), device=device)


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
