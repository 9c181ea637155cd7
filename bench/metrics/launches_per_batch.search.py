"""Mean CUDA kernels started inside a ``knn_query`` span (the profiler's
trace; copies and sets are not kernels)."""


def read(obs):
    rows = (obs.trace or {}).get("per_span", {}).get("knn_query")
    if not rows or not sum(r[0] for r in rows):
        return None
    return sum(n for _, n in rows) / len(rows)
