"""Share of the beam search's computed distances that went to rows not
seen before: 100 x the rows the lanes marked visited over steps x lanes x
M0 (a step computes one distance per lane and neighbour slot), summed over
the layer-0 ``search.layer`` spans under ``index.knn_query`` of the
profiled window (``rows_visited`` is counted only while the profiler
records)."""
from bench.program_spans import attr, spans

PROGRAM = True


def read(obs):
    s = spans(obs, "search.layer", obs.traced, under="index.knn_query")
    s = [x for x in s or () if x.attrs.get("layer") == 0]
    rows = [attr(x, "rows_visited") for x in s]
    if not s or None in rows:
        return None
    computed = sum(attr(x, "steps") * attr(x, "lanes") for x in s)
    if computed <= 0:
        return None
    return 100.0 * sum(rows) / (computed * obs.program.cfg["M0"])
