"""Real-time serving engine over the port's MN-RU HNSW core.

Micro-batched queries against epoch snapshots, while a scheduler streams
mixed delete/replace/insert batches through the wave executor and folds
tau-triggered backup rebuilds and health-driven maintenance into the cycle.

The blessed way to construct an engine is
``repro_torch.api.VectorIndex.serve(...)``; the classes here remain public
for drivers that manage the index themselves.
"""
from ..core.batch_update import WavePlan, compile_tape
from ..core.maintenance import MaintenancePolicy
from ..core.strategies import get_executor, list_executors

from .batcher import MicroBatcher, QueryTicket, bucket_size, pow2_floor
from .engine import PumpStats, ServingEngine
from .metrics import Counter, Histogram, MetricsRegistry
from .snapshot import EpochSnapshot, SnapshotStore
from .update_queue import UpdateOp, UpdateScheduler

__all__ = [
    "MicroBatcher", "QueryTicket", "bucket_size", "pow2_floor",
    "PumpStats", "ServingEngine",
    "Counter", "Histogram", "MetricsRegistry",
    "EpochSnapshot", "SnapshotStore",
    "UpdateOp", "UpdateScheduler",
    # re-export: the engine's maintenance= policy type lives in core
    "MaintenancePolicy",
    # re-export: the drain path's wave-tape compiler + executor registry
    "WavePlan", "compile_tape", "get_executor", "list_executors",
]
