"""`repro_torch.api` — the public surface of the port's vector database.

One facade (:class:`VectorIndex`, :func:`create`) and the two extension
registries, as in the reference's ``repro.api``:

  * metric spaces  — ``l2`` / ``ip`` / ``cosine`` built in; add your own
    with :func:`register_metric`;
  * update strategies — the paper's ``hnsw_ru`` / ``mn_ru_*`` /
    ``mn_thn_ru`` family built in; add your own with
    :func:`register_strategy`.
"""
from ..core.maintenance import IndexHealth, MaintenancePolicy
from ..core.metrics import Metric, get_metric, list_metrics, register_metric
from ..core.planner import (DEFAULT_PLANNER, MODES, IndexStats, PlanDecision,
                            PlannerConfig, choose_tier, index_stats)
from ..core.strategies import (UpdateStrategy, get_executor, get_strategy,
                               list_executors, list_strategies,
                               register_executor, register_strategy)

from .facade import VectorIndex, create

__all__ = [
    "VectorIndex", "create",
    "Metric", "get_metric", "list_metrics", "register_metric",
    "UpdateStrategy", "get_strategy", "list_strategies", "register_strategy",
    "get_executor", "list_executors", "register_executor",
    "DEFAULT_PLANNER", "MODES", "IndexStats", "PlanDecision",
    "PlannerConfig", "choose_tier", "index_stats",
    "IndexHealth", "MaintenancePolicy",
]
