from .pipeline import PrefetchPipeline, SyntheticStream
from .synthetic import (brute_force_knn, clustered_vectors, exact_knn,
                        gnn_batch, lm_token_batch, recsys_batch)

__all__ = ["brute_force_knn", "clustered_vectors", "exact_knn",
           "gnn_batch", "lm_token_batch", "recsys_batch", "PrefetchPipeline",
           "SyntheticStream"]
