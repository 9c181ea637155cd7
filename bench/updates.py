"""A stream of updates drawn from the seed, for the mixes that churn.

Update ``i`` deletes a label of the live set as submitted so far (op
``2 i``) and puts a fresh row under the new label ``n0 + i`` (op
``2 i + 1``). The new label takes the deleted one's place in the live
array, so its size stays ``n0``. Which place is hit, and what the new row
is, are parts the mix names (``"updates": {"labels": {"draw": ...},
"rows": {"draw": ...}}``), each a file found by that name:

  * ``bench/draws/labels/<draw>.py`` — ``pick(rng, live, params) -> int``,
    a place in the live array;
  * ``bench/draws/rows/<draw>.py`` — ``rows(seed, chunk, n, d, params)``,
    the ``n`` rows of chunk ``chunk`` as float32 ``[n, d]``.

``params`` is the draw's own entry of the mix file.
"""
from __future__ import annotations

import numpy as np

from .common import load_file
from .reference import data as D


class UpdateStream:
    CHUNK = 512

    def __init__(self, seed: int, n0: int, d: int, spec: dict, root):
        self.seed, self.n0, self.d = seed, n0, d
        self.label_params = spec["labels"]
        self.row_params = spec["rows"]
        self._pick = load_file(root, "draws/labels",
                               self.label_params["draw"]).pick
        self._rows = load_file(root, "draws/rows",
                               self.row_params["draw"]).rows
        self.live = np.arange(n0, dtype=np.int64)
        self.rng = np.random.default_rng(D.stream_seed(seed, D.UPDATE_LABELS))
        self.count = 0
        self.chunks: list[np.ndarray] = []
        self.killed: list[int] = []          # label deleted by update i

    def next(self) -> tuple[int, int, np.ndarray]:
        j = int(self._pick(self.rng, self.live, self.label_params))
        old, new = int(self.live[j]), self.n0 + self.count
        self.live[j] = new
        c, r = divmod(self.count, self.CHUNK)
        if c == len(self.chunks):
            self.chunks.append(np.asarray(self._rows(
                self.seed, c, self.CHUNK, self.d, self.row_params),
                np.float32))
        self.killed.append(old)
        self.count += 1
        return old, new, self.chunks[c][r]

    def rows(self) -> np.ndarray:
        if not self.chunks:
            return np.empty((0, self.d), np.float32)
        return np.concatenate(self.chunks)[:self.count]

    def birth_death(self) -> tuple[np.ndarray, np.ndarray]:
        """Per label ``0 .. n0 + count - 1``: the op that made it live
        (-1: the build) and the op that deleted it (none: int64 max)."""
        R = self.n0 + self.count
        birth = np.full(R, -1, np.int64)
        birth[self.n0:] = 2 * np.arange(self.count) + 1
        death = np.full(R, np.iinfo(np.int64).max, np.int64)
        killed = np.asarray(self.killed, np.int64)
        ops = 2 * np.arange(self.count, dtype=np.int64)
        np.minimum.at(death, killed, ops)
        return birth, death
