"""The benchmark's plain reference of dualSearch's merge (paper Algorithm
1) as the program serves it, in plain ``torch`` and Python: no JAX and
nothing of the program (the tier-1 tests keep the same merge as
``tests/dual_search_ref.py``).

Given the main index's and the backup index's candidate lists for each
query (labels and distances, main's first; label -1 is an empty entry) and
the labels live in the main index, :func:`dual_merge` returns the merged
top-``k``:

  * a backup hit whose label is not live in main is dropped;
  * a label found twice keeps its first entry (main's before backup's);
  * the rest are ordered by distance, ties in list order (main's first);
  * a row is padded with -1 / inf only where fewer than ``k`` remain.
"""
from __future__ import annotations

import torch


def dual_merge(main_labels, main_dists, backup_labels, backup_dists,
               live, k: int):
    """``(labels[B, k] int64, dists[B, k] float32)`` of the merge; ``live``
    is a collection of the labels live in the main index."""
    live = {int(x) for x in live}
    B = len(main_labels)
    labels = torch.full((B, k), -1, dtype=torch.int64)
    dists = torch.full((B, k), float("inf"), dtype=torch.float32)
    for b in range(B):
        cands, seen = [], set()
        lists = ((main_labels[b], main_dists[b], False),
                 (backup_labels[b], backup_dists[b], True))
        for ls, ds, from_backup in lists:
            for lab, dist in zip(torch.as_tensor(ls).tolist(),
                                 torch.as_tensor(ds).tolist()):
                if lab < 0 or lab in seen:
                    continue
                if from_backup and lab not in live:
                    continue
                seen.add(lab)
                cands.append((dist, len(cands), lab))
        cands.sort()
        for j, (dist, _, lab) in enumerate(cands[:k]):
            labels[b, j] = lab
            dists[b, j] = dist
    return labels, dists


def eligible(main_labels, backup_labels, live) -> list[int]:
    """Per row, the number of distinct labels the merge may serve."""
    live = {int(x) for x in live}
    out = []
    for m, bk in zip(main_labels, backup_labels):
        ok = {x for x in torch.as_tensor(m).tolist() if x >= 0}
        ok |= {x for x in torch.as_tensor(bk).tolist() if x in live}
        out.append(len(ok))
    return out
