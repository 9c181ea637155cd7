from .synthetic import brute_force_knn, clustered_vectors, exact_knn

__all__ = ["brute_force_knn", "clustered_vectors", "exact_knn"]
