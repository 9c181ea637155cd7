"""Mean host milliseconds of the facade's filter mask
(``index.filter_mask``: the labels and flags copied to the host, then the
label match) per filtered batch in the untraced window."""
from bench.program_spans import spans

PROGRAM = True


def read(obs):
    s = spans(obs, "index.filter_mask", obs.window)
    if s is None:
        return None
    return 1e3 * sum(x.seconds for x in s) / len(s)
