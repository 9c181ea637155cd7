"""Share of the served top-k entries that came from the backup index:
100 x the ``backup_hits`` of the ``search.dual`` spans in the untraced
window over their ``rows`` x k."""
from bench.program_spans import attr, spans

PROGRAM = True


def read(obs):
    s = spans(obs, "search.dual", obs.window)
    hits = [attr(x, "backup_hits") for x in s or ()]
    rows = sum(attr(x, "rows") or 0 for x in s or ())
    if not s or None in hits or rows <= 0:
        return None
    return 100.0 * sum(hits) / (rows * obs.program.k)
