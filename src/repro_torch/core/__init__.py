"""Paper core on PyTorch: batched HNSW with real-time updates (MN-RU family).

Functions take and return :class:`HNSWIndex` dataclasses of tensors; those
that change an index update it in place (see ``core.hnsw``).
"""
from .index import (HNSWIndex, HNSWParams, empty_index, from_arrays,
                    resize_index, sample_level, sample_levels, to_arrays)
from .metrics import (Metric, dist_pairwise, dist_point, get_metric,
                      list_metrics, register_metric)
from .strategies import (BUILTIN_STRATEGIES, UpdateStrategy, get_executor,
                         get_strategy, list_executors, list_strategies,
                         register_executor, register_strategy)
from .hnsw import build, insert
from .batch_update import (WavePlan, apply_plan, apply_update_batch_wave,
                           build_batch, compile_tape)
from .search import batch_knn, greedy_layer, knn_search, search_layer
from .update import (OP_DELETE, OP_INSERT, OP_NOP, OP_REPLACE,
                     apply_update_batch, apply_update_batch_sequential,
                     delete_and_update_batch, first_deleted_slot,
                     first_free_slot, mark_delete, num_deleted,
                     replaced_update, slot_of_label)
from .planner import (DEFAULT_PLANNER, MODES, IndexStats, PlanDecision,
                      PlannerConfig, choose_tier, exact_scan, index_stats,
                      plan_and_search)
from .reach import (bfs_reachable, bfs_unreachable, count_unreachable,
                    indegree, indegree_unreachable)
from .backup import (DualIndexManager, batch_dual_search, dual_search,
                     rebuild_backup)
from .maintenance import (IndexHealth, MaintenancePolicy, consolidate_deletes,
                          index_health, rebuild_index, repair_unreachable,
                          run_maintenance)

__all__ = [
    "HNSWIndex", "HNSWParams", "empty_index", "from_arrays", "resize_index",
    "sample_level", "sample_levels", "to_arrays",
    "Metric", "dist_pairwise", "dist_point", "get_metric", "list_metrics",
    "register_metric",
    "BUILTIN_STRATEGIES", "UpdateStrategy", "get_strategy",
    "list_strategies", "register_strategy", "get_executor", "list_executors",
    "register_executor",
    "build", "insert", "build_batch",
    "WavePlan", "apply_plan", "apply_update_batch_wave", "compile_tape",
    "batch_knn", "greedy_layer", "knn_search", "search_layer",
    "DEFAULT_PLANNER", "MODES", "IndexStats", "PlanDecision",
    "PlannerConfig", "choose_tier", "exact_scan", "index_stats",
    "plan_and_search",
    "OP_DELETE", "OP_INSERT", "OP_NOP", "OP_REPLACE",
    "apply_update_batch", "apply_update_batch_sequential",
    "delete_and_update_batch", "first_deleted_slot", "first_free_slot",
    "mark_delete", "num_deleted", "replaced_update", "slot_of_label",
    "bfs_reachable", "bfs_unreachable", "count_unreachable", "indegree",
    "indegree_unreachable",
    "DualIndexManager", "batch_dual_search", "dual_search", "rebuild_backup",
    "IndexHealth", "MaintenancePolicy", "consolidate_deletes", "index_health",
    "rebuild_index", "repair_unreachable", "run_maintenance",
]
