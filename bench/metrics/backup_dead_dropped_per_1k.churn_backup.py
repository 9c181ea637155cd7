"""Backup hits dropped as no longer live in the main index, per 1,000
queries served: the ``dead_dropped`` of the ``search.dual`` spans in the
untraced window over their ``rows``. How often the live test engages."""
from bench.program_spans import attr, spans

PROGRAM = True


def read(obs):
    s = spans(obs, "search.dual", obs.window)
    dropped = [attr(x, "dead_dropped") for x in s or ()]
    rows = sum(attr(x, "rows") or 0 for x in s or ())
    if not s or None in dropped or rows <= 0:
        return None
    return 1e3 * sum(dropped) / rows
