"""The HNSW index as a dataclass of tensors + its static hyper-parameters.

Layout (identical to the reference's npz layout, field for field):
  vectors   f32[N, d]      point payloads (slot-indexed)
  labels    i32[N]         external label per slot (-1 = free)
  levels    i32[N]         max layer of the point (-1 = free slot)
  neighbors i32[L, N, M0]  adjacency; layer 0 uses all M0 slots, layers >0
                           use only the first M slots (rest stay -1)
  deleted   bool[N]        markDelete flags (slots still traversable)
  entry     i32[]          entry point slot id
  max_layer i32[]          current top layer
  count     i32[]          number of live (non-free) slots
  rng       u32[2]         the reference's PRNG key, carried as opaque state

A backup index (``core.backup``) also carries ``source``: i32[N], the main
index's slot each backup slot was copied from (-1 = none), which dualSearch
requires; other indexes leave it None. It is not part of the npz layout.

Randomness never comes from ``rng``: every draw takes an explicit
``torch.Generator`` (levels, reuse cursors), or an override so that tests
can feed in the reference's draws.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .common import host_array, resolve_device, tensor_from_host

FIELDS = ("vectors", "labels", "levels", "neighbors", "deleted", "entry",
          "max_layer", "count", "rng")


@dataclasses.dataclass(frozen=True)
class HNSWParams:
    """Static (hashable) hyper-parameters."""
    M: int = 8                 # max degree, layers > 0
    M0: int = 16               # max degree, layer 0 (conventionally 2M)
    num_layers: int = 4        # static layer count L
    ef_construction: int = 64
    ef_search: int = 32
    alpha: float = 1.0         # alpha-RNG pruning parameter
    max_search_steps: int = 0  # 0 => 4*ef + 32
    space: str = "l2"          # metric space (see core.metrics registry)

    def m_for_layer(self, layer: int) -> int:
        return self.M0 if layer == 0 else self.M

    def steps_for(self, ef: int) -> int:
        return self.max_search_steps if self.max_search_steps > 0 else 4 * ef + 32


@dataclasses.dataclass
class HNSWIndex:
    vectors: torch.Tensor
    labels: torch.Tensor
    levels: torch.Tensor
    neighbors: torch.Tensor
    deleted: torch.Tensor
    entry: torch.Tensor
    max_layer: torch.Tensor
    count: torch.Tensor
    rng: torch.Tensor
    source: torch.Tensor | None = None

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    def clone(self) -> "HNSWIndex":
        """A deep copy (updates work in place; clone to keep a state)."""
        return HNSWIndex(
            **{f: getattr(self, f).clone() for f in FIELDS},
            source=None if self.source is None else self.source.clone())


def _scalar(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def seed_key(seed: int) -> torch.Tensor:
    """The reference's ``jax.random.PRNGKey(seed)`` words (threefry layout,
    32-bit seeds), kept only so that ``rng`` round-trips through the npz
    layout."""
    return torch.tensor([0, int(seed) & 0xFFFFFFFF],
                        dtype=torch.int64).to(torch.uint32)


def empty_index(params: HNSWParams, capacity: int, dim: int, seed: int = 0,
                dtype=torch.float32, device="cuda") -> HNSWIndex:
    dev = resolve_device(device)
    return HNSWIndex(
        vectors=torch.zeros((capacity, dim), dtype=dtype, device=dev),
        labels=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        levels=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        neighbors=torch.full((params.num_layers, capacity, params.M0), -1,
                             dtype=torch.int32, device=dev),
        deleted=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        entry=_scalar(-1, dev),
        max_layer=_scalar(-1, dev),
        count=_scalar(0, dev),
        rng=seed_key(seed),
    )


def resize_index(index: HNSWIndex, new_capacity: int) -> HNSWIndex:
    """Repack into a larger capacity (a no-op when not larger); slot ids are
    stable and new slots are appended at the tail as free entries."""
    cap = index.capacity
    if new_capacity <= cap:
        return index
    pad = new_capacity - cap
    L, _, M0 = index.neighbors.shape
    dev = index.device
    return dataclasses.replace(
        index,
        vectors=torch.cat([index.vectors, torch.zeros(
            (pad, index.dim), dtype=index.vectors.dtype, device=dev)]),
        labels=torch.cat([index.labels, torch.full(
            (pad,), -1, dtype=torch.int32, device=dev)]),
        levels=torch.cat([index.levels, torch.full(
            (pad,), -1, dtype=torch.int32, device=dev)]),
        neighbors=torch.cat([index.neighbors, torch.full(
            (L, pad, M0), -1, dtype=torch.int32, device=dev)], dim=1),
        deleted=torch.cat([index.deleted, torch.zeros(
            (pad,), dtype=torch.bool, device=dev)]),
    )


def sample_levels(generator: torch.Generator | None, params: HNSWParams,
                  n: int, device="cpu") -> torch.Tensor:
    """``n`` HNSW levels, floor(-ln(U) / ln(M)) capped at L-1, drawn from
    ``generator`` (a CPU generator, so a seed gives the same levels on
    every device)."""
    e = torch.empty((n,), dtype=torch.float32).exponential_(
        generator=generator)                           # = -ln(U)
    lvl = torch.floor(e * (1.0 / math.log(params.M))).to(torch.int32)
    return torch.clamp(lvl, 0, params.num_layers - 1).to(device)


def sample_level(generator: torch.Generator | None,
                 params: HNSWParams) -> int:
    """One HNSW level drawn from ``generator``."""
    return int(sample_levels(generator, params, 1)[0])


def from_arrays(d: dict, device="cuda") -> HNSWIndex:
    """Load the reference's arrays (the facade's npz layout) unchanged."""
    dev = resolve_device(device)
    dtypes = {"labels": np.int32, "levels": np.int32, "neighbors": np.int32,
              "deleted": np.bool_, "entry": np.int32, "max_layer": np.int32,
              "count": np.int32, "rng": np.uint32}
    out = {}
    for name in FIELDS:
        a = np.asarray(d[name])
        if name in dtypes:
            a = a.astype(dtypes[name], copy=False)
        t = tensor_from_host(a)
        out[name] = t if name == "rng" else t.to(dev)
    return HNSWIndex(**out)


def to_arrays(index: HNSWIndex) -> dict[str, np.ndarray]:
    """The index as numpy arrays in the facade's npz layout (bf16 vectors
    as the reference's npz holds them: 2-byte void)."""
    return {name: host_array(getattr(index, name)) for name in FIELDS}
