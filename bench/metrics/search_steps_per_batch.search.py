"""Mean lockstep steps of the beam search at layer 0 per query batch: the
``steps`` of each layer-0 ``search.layer`` span under ``index.knn_query``
in the untraced window (the host's loop count, which costs nothing)."""
from bench.program_spans import attr, spans

PROGRAM = True


def read(obs):
    s = spans(obs, "search.layer", obs.window, under="index.knn_query")
    steps = [attr(x, "steps") for x in s or () if x.attrs.get("layer") == 0]
    if not steps or None in steps:
        return None
    return sum(steps) / len(steps)
