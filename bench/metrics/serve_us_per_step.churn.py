"""Host microseconds a step of the served batches' beam search: the layer-0
``search.layer`` spans under ``batcher.batch`` in the untraced window, over
the steps their loops ran."""
from bench.program_spans import attr, spans

PROGRAM = True


def read(obs):
    s = spans(obs, "search.layer", obs.window, under="batcher.batch")
    s = [x for x in s or () if x.attrs.get("layer") == 0]
    steps = sum(attr(x, "steps") for x in s)
    if not s or steps <= 0:
        return None
    return 1e6 * sum(x.seconds for x in s) / steps
