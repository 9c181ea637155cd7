"""Shared-nothing sharded ANN index: per-shard search + routed updates.

Each shard owns the labels with ``label % nshards == shard`` and a private
HNSW sub-graph. A global query fans out to every shard, each returns its
own top-k, and one stable merge in shard order yields the global top-k.
An update runs on its owner shard only; the other shards are not touched.

The reference stacks the shards on a leading axis and runs them under one
``shard_map``. Here a :class:`ShardedIndex` is a list of per-shard
:class:`HNSWIndex`\\ es in one process, each on its own device (a list of
devices, cycled, stands in for the mesh axis): on one card every shard
sits on that card, on several cards they spread with no code change.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..launch.mesh import make_local_mesh
from .batch_update import _host
from .common import INF, stable_argsort, storage_tensor
from .hnsw import WAVE_BUILD_MIN_N, build, insert
from .index import FIELDS, HNSWIndex, HNSWParams, from_arrays, to_arrays
from .search import batch_knn
from .strategies import get_strategy
from .update import first_free_slot, mark_delete, replaced_update


@dataclasses.dataclass
class ShardedIndex:
    """``nshards`` sub-indexes of one capacity, shard ``s`` owning the
    labels with ``label % nshards == s``."""
    shards: list[HNSWIndex]

    @property
    def nshards(self) -> int:
        return len(self.shards)

    @property
    def dim(self) -> int:
        return self.shards[0].dim

    @property
    def devices(self) -> list[torch.device]:
        return [ix.device for ix in self.shards]

    @property
    def device(self) -> torch.device:
        """Where merged results land: the first shard's device."""
        return self.shards[0].device

    def clone(self) -> "ShardedIndex":
        return ShardedIndex([ix.clone() for ix in self.shards])

    def stacked_arrays(self) -> dict[str, np.ndarray]:
        """The reference's stacked layout: every field of the npz layout
        with a leading shard axis."""
        per = [to_arrays(ix) for ix in self.shards]
        return {f: np.stack([a[f] for a in per]) for f in FIELDS}

    @classmethod
    def from_stacked(cls, arrays, devices) -> "ShardedIndex":
        """Load a stacked layout (the reference's ``build_sharded`` output as
        numpy), shard ``s`` onto ``devices[s % len(devices)]``."""
        S = np.asarray(arrays["vectors"]).shape[0]
        return cls([from_arrays({f: np.asarray(arrays[f])[s] for f in FIELDS},
                                device=devices[s % len(devices)])
                    for s in range(S)])


def build_sharded(params: HNSWParams, vectors, labels=None, *, nshards: int,
                  seed: int = 0, capacity: int | None = None, devices=None,
                  draws=None) -> ShardedIndex:
    """Build ``nshards`` sub-indexes, shard ``s`` over the rows whose label
    has ``label % nshards == s`` (in row order), with seed ``seed + s``.

    ``capacity`` is the PER-SHARD slot count (default: exactly full);
    oversize it to leave free slots for fresh inserts. Shard ``s`` is built
    on ``devices[s % len(devices)]`` (default: this host's GPUs). ``draws[s]``
    feeds shard ``s``'s build the levels (sequential route, below
    ``WAVE_BUILD_MIN_N`` points) or the wave draws (``build_batch``'s
    ``draws``) to use.
    """
    X = storage_tensor(vectors)
    n = X.shape[0]
    labels = (np.arange(n, dtype=np.int32) if labels is None
              else _host(labels).astype(np.int32))
    per = -(-n // nshards)
    cap = capacity if capacity is not None else per
    if cap < per:
        raise ValueError(f"per-shard capacity {cap} < {per} needed for "
                         f"{n} vectors on {nshards} shards")
    if devices is None:
        devices = make_local_mesh()
    shards = []
    for s in range(nshards):
        sel = np.nonzero(labels % nshards == s)[0]
        if len(sel) > per:
            raise ValueError(f"shard {s} owns {len(sel)} labels, more than "
                             f"the {per} a shard holds: labels must spread "
                             f"evenly over label % {nshards}")
        feed = {}
        if draws is not None:
            feed = ({"draws": draws[s]} if len(sel) >= WAVE_BUILD_MIN_N
                    else {"levels": draws[s]})
        shards.append(build(params, X[torch.from_numpy(sel)], labels[sel],
                            seed=seed + s, capacity=cap,
                            device=devices[s % len(devices)], **feed))
    return ShardedIndex(shards)


def _moved(index: HNSWIndex, device) -> HNSWIndex:
    return HNSWIndex(**{f: getattr(index, f) if f == "rng"
                        else getattr(index, f).to(device) for f in FIELDS})


def shard_index(sharded: ShardedIndex, devices) -> ShardedIndex:
    """Place shard ``s`` on ``devices[s % len(devices)]`` (shards already
    there are not copied)."""
    return ShardedIndex([_moved(ix, devices[s % len(devices)])
                         for s, ix in enumerate(sharded.shards)])


def sharded_batch_knn(params: HNSWParams, sharded: ShardedIndex, Q, k: int,
                      ef: int | None = None):
    """Global top-k: ``(labels[b, k], dists[b, k])`` on the first shard's
    device.

    Each shard searches on its own device; the per-shard answers are laid
    out shard-major (``[b, S*k]``) and merged by a stable sort, so ties go
    to the lower shard, then to the shard's own order.
    """
    Q = torch.as_tensor(Q, dtype=torch.float32)
    out = sharded.device
    labels, dists = [], []
    for ix in sharded.shards:
        lbl, _, dist = batch_knn(params, ix, Q.to(ix.device), k, ef)
        labels.append(lbl.to(out))
        dists.append(dist.to(out))
    b = Q.shape[0]
    lbl_g = torch.stack(labels, 1).reshape(b, sharded.nshards * k)
    dist_g = torch.stack(dists, 1).reshape(b, sharded.nshards * k)
    dist_g = torch.where(lbl_g < 0, INF, dist_g)
    order = stable_argsort(dist_g)[:, :k]
    return lbl_g.gather(1, order), dist_g.gather(1, order)


def sharded_update(params: HNSWParams, sharded: ShardedIndex, del_label,
                   x, new_label, variant: str = "mn_ru_gamma",
                   fresh_insert: bool = False, *, slot: int | None = None,
                   level: int | None = None,
                   generator: torch.Generator | None = None) -> ShardedIndex:
    """Route one delete + replace to the owning shards, in place.

    A negative ``del_label`` / ``new_label`` disables that half of the op.
    The owner of ``del_label`` mark-deletes it; then the owner of
    ``new_label`` runs ``replaced_update`` or, with ``fresh_insert=True``, a
    plain insert into its first free slot (a no-op when the shard is full;
    never consumes a deleted slot). ``slot=``/``level=`` override the new
    half's slot and level draws.
    """
    get_strategy(variant)
    S = sharded.nshards
    del_label, new_label = int(del_label), int(new_label)
    if del_label >= 0:
        mark_delete(sharded.shards[del_label % S], del_label)
    if new_label < 0:
        return sharded
    ix = sharded.shards[new_label % S]
    x = torch.as_tensor(x, dtype=ix.vectors.dtype).to(ix.device)
    if fresh_insert:
        pid = slot if slot is not None else first_free_slot(
            ix, generator=generator)
        if pid >= 0:
            insert(params, ix, x, pid, new_label, level, generator)
    else:
        replaced_update(params, ix, x, new_label, variant, slot=slot,
                        level=level, generator=generator)
    return sharded
