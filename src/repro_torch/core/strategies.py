"""Update-strategy registry (the paper's replaced_update family) and the
tape-executor registry (how a drained op tape is applied).

The five built-ins register themselves below; every entry point validates
through :func:`get_strategy`, and third-party strategies plug in via
:func:`register_strategy` — either as a new (repair_set, candidate_pool,
repair_alpha) combination or with a fully custom ``repair_fn``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

REPAIR_SETS = ("one_hop", "mutual", "mutual_thn")
CANDIDATE_POOLS = ("two_hop", "per_vertex")


@dataclasses.dataclass(frozen=True)
class UpdateStrategy:
    """One replaced_update repair policy.

    ``repair_set``      — which vertices around the deleted point get their
                          adjacency rebuilt (paper §III).
    ``candidate_pool``  — where repair candidates come from: the shared
                          one-hop ∪ two-hop pool, or the per-vertex
                          N(v) ∪ N(d) ∪ {new} pool.
    ``repair_alpha``    — alpha-RNG parameter for the repair prune.
    ``repair_fn``       — optional full override, called as
                          ``repair_fn(params, nbrs, vectors, deleted, pid,
                          layer, strategy)``; it updates ``nbrs`` in place.
    """
    name: str
    repair_set: str = "mutual"
    candidate_pool: str = "per_vertex"
    repair_alpha: float = 1.0
    repair_fn: Callable | None = None

    def __post_init__(self):
        if self.repair_fn is None:
            if self.repair_set not in REPAIR_SETS:
                raise ValueError(f"repair_set must be one of {REPAIR_SETS}, "
                                 f"got {self.repair_set!r}")
            if self.candidate_pool not in CANDIDATE_POOLS:
                raise ValueError(f"candidate_pool must be one of "
                                 f"{CANDIDATE_POOLS}, got "
                                 f"{self.candidate_pool!r}")


_STRATEGIES: dict[str, UpdateStrategy] = {}


def register_strategy(strategy: UpdateStrategy,
                      *, overwrite: bool = False) -> UpdateStrategy:
    """Register ``strategy`` under its name; returns it."""
    if strategy.name in _STRATEGIES and not overwrite:
        raise ValueError(f"update strategy {strategy.name!r} is already "
                         f"registered; pass overwrite=True to replace it")
    _STRATEGIES[strategy.name] = strategy
    return strategy


def get_strategy(name: str) -> UpdateStrategy:
    """Look up a registered strategy (THE uniform unknown-strategy error)."""
    try:
        return _STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown update strategy {name!r}; registered strategies: "
            f"{list_strategies()}") from None


def list_strategies() -> tuple[str, ...]:
    return tuple(sorted(_STRATEGIES))


register_strategy(UpdateStrategy("hnsw_ru", "one_hop", "two_hop", 1.0))
register_strategy(UpdateStrategy("mn_ru_alpha", "mutual", "two_hop", 1.0))
register_strategy(UpdateStrategy("mn_ru_beta", "mutual", "per_vertex", 1.0))
register_strategy(UpdateStrategy("mn_ru_gamma", "mutual", "per_vertex", 1.1))
register_strategy(UpdateStrategy("mn_thn_ru", "mutual_thn", "per_vertex", 1.1))

BUILTIN_STRATEGIES = ("hnsw_ru", "mn_ru_alpha", "mn_ru_beta", "mn_ru_gamma",
                      "mn_thn_ru")


_EXECUTORS: dict[str, Callable] = {}

#: modules whose import registers the built-in executors (resolved lazily)
_BUILTIN_EXECUTOR_MODULES = ("repro_torch.core.update",
                             "repro_torch.core.batch_update")


def register_executor(name: str, fn: Callable,
                      *, overwrite: bool = False) -> Callable:
    """Register a tape executor ``fn(params, index, ops, labels, X,
    variant, **draws) -> index`` under ``name``; returns ``fn``."""
    if name in _EXECUTORS and not overwrite:
        raise ValueError(f"tape executor {name!r} is already registered; "
                         f"pass overwrite=True to replace it")
    _EXECUTORS[name] = fn
    return fn


def get_executor(name: str) -> Callable:
    """Look up a tape executor (THE uniform unknown-executor error)."""
    if name not in _EXECUTORS:
        for mod in _BUILTIN_EXECUTOR_MODULES:
            importlib.import_module(mod)
    try:
        return _EXECUTORS[name]
    except KeyError:
        raise ValueError(
            f"unknown tape execution {name!r}; registered executors: "
            f"{list_executors()}") from None


def list_executors() -> tuple[str, ...]:
    return tuple(sorted(_EXECUTORS))
