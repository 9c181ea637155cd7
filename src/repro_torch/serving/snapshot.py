"""Double-buffered epoch snapshots of the index: readers never see writes.

The serving engine keeps two logical buffers:

  * the FRONT buffer — the published :class:`EpochSnapshot` every query
    batch runs against; once handed to a reader it never changes;
  * the BACK buffer — the writer's working copy, advanced by the update
    drain, backup rebuilds and maintenance passes, and staged with
    :meth:`SnapshotStore.stage`.

``publish()`` swaps the staged back buffer in as the new front snapshot
and bumps the epoch counter. A reader that grabbed the old snapshot keeps
a fully consistent view (index + backup pair from the SAME epoch).

The reference gets isolation for free from immutable JAX arrays. The port
updates indexes in place, so a writer asks for :meth:`SnapshotStore.
writable_index`, which hands back a ``clone()`` of the published index the
first time after each publish; every in-place write then lands on that
copy, never on a snapshot a reader holds.
"""
from __future__ import annotations

import dataclasses

from ..core.index import HNSWIndex


@dataclasses.dataclass(frozen=True)
class EpochSnapshot:
    """One query-servable version of the index state (never written)."""
    epoch: int
    index: HNSWIndex
    backup: HNSWIndex | None = None

    @property
    def has_backup(self) -> bool:
        return self.backup is not None


class SnapshotStore:
    """Owns the front/back buffers and the epoch counter."""

    def __init__(self, index: HNSWIndex, backup: HNSWIndex | None = None):
        self._front = EpochSnapshot(0, index, backup)
        self._back_index = index
        self._back_backup = backup
        self._dirty = False

    # -- reader side --------------------------------------------------------
    @property
    def epoch(self) -> int:
        return self._front.epoch

    def current(self) -> EpochSnapshot:
        """The published snapshot; safe to hold across any number of writes."""
        return self._front

    # -- writer side --------------------------------------------------------
    def working_index(self) -> HNSWIndex:
        """The back-buffer index, to read (it may still be the published
        one: do not update it in place — see :meth:`writable_index`)."""
        return self._back_index

    def writable_index(self) -> HNSWIndex:
        """The back-buffer index, safe to update in place: a clone of the
        published index when the back buffer still is the published one."""
        if self._back_index is self._front.index:
            self._back_index = self._back_index.clone()
        return self._back_index

    def working_backup(self) -> HNSWIndex | None:
        return self._back_backup

    def stage(self, index: HNSWIndex | None = None,
              backup: HNSWIndex | None = None) -> None:
        """Stage new back-buffer state; invisible to readers until publish."""
        if index is not None:
            self._back_index = index
            self._dirty = True
        if backup is not None:
            self._back_backup = backup
            self._dirty = True

    @property
    def dirty(self) -> bool:
        return self._dirty

    def publish(self) -> EpochSnapshot:
        """Swap the staged back buffer in as the new front snapshot.

        No-op (same epoch) when nothing was staged, so an idle maintenance
        cycle doesn't invalidate reader-visible state.
        """
        if self._dirty:
            self._front = EpochSnapshot(self._front.epoch + 1,
                                        self._back_index, self._back_backup)
            self._dirty = False
        return self._front
