"""Host microseconds of dualSearch a served query: the ``search.dual``
spans under ``batcher.batch`` in the untraced window (both indexes'
searches, the live test and the merge, up to the read of its counts),
over the queries they served (``rows``, pad rows left out)."""
from bench.program_spans import attr, spans

PROGRAM = True


def read(obs):
    s = spans(obs, "search.dual", obs.window, under="batcher.batch")
    rows = sum(attr(x, "rows") or 0 for x in s or ())
    if not s or rows <= 0:
        return None
    return 1e6 * sum(x.seconds for x in s) / rows
