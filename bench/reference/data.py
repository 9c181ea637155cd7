"""Seeded inputs: a frozen copy of the program's data generator.

``clustered_vectors`` is a copy of ``repro_torch.data.synthetic.
clustered_vectors`` (itself the reference package's generator): a mixture
of 32 isotropic Gaussians around unit centres. The benchmark keeps its own
copy so that a change to the program's generator cannot change the data it
is measured on.
"""
from __future__ import annotations

import numpy as np

#: the seed of the mixture every run draws from: its 32 unit centres are
#: the same in every run (the dataset's shape), so that a run's seed changes
#: which rows, queries and updates it draws, not how hard the data is
MIXTURE = 0
#: sub-streams of one run's seed
DATA, QUERIES, ARRIVALS, UPDATE_LABELS, CATEGORIES, INDEX, CATEGORY_ORDER = \
    range(7)
#: update rows come in chunks, chunk ``c`` from sub-stream ``UPDATE_ROWS + c``
UPDATE_ROWS = 1000


def clustered_vectors(n: int, d: int, n_clusters: int = 32, seed: int = 0,
                      scale: float = 0.15,
                      noise_seed: int | None = None) -> np.ndarray:
    """Mixture-of-Gaussians point cloud on the unit sphere shell.

    ``noise_seed`` draws fresh rows of the mixture that ``seed`` defines:
    the same cluster centres, new assignments and noise.
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    if noise_seed is not None:
        rng = np.random.default_rng(noise_seed)
    assign = rng.integers(0, n_clusters, size=n)
    X = centers[assign] + scale * rng.normal(size=(n, d))
    return X.astype(np.float32)


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one sub-stream of a run's ``--seed`` (any integer)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), int(stream)])
    return int(ss.generate_state(2, np.uint64)[0] >> np.uint64(1))


def draw(n: int, d: int, seed: int, stream: int) -> np.ndarray:
    """``n`` rows of the mixture, from sub-stream ``stream`` of ``seed``."""
    return clustered_vectors(n, d, seed=MIXTURE,
                             noise_seed=stream_seed(seed, stream))


def normalize(X: np.ndarray) -> np.ndarray:
    """Unit rows in float64 (the cosine space's ingest, computed apart)."""
    X = np.asarray(X, np.float64)
    return X / (np.sqrt((X * X).sum(axis=-1, keepdims=True)) + 1e-12)
