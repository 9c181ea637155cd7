"""Mean device milliseconds of the kernels, copies and sets that started
inside a ``knn_query`` span (the profiler's trace)."""


def read(obs):
    rows = (obs.trace or {}).get("per_span", {}).get("knn_query")
    if not rows or not sum(r[0] for r in rows):
        return None
    return 1e3 * sum(s for s, _ in rows) / len(rows)
