"""Host seconds of the wave executor's ``wave.candidates`` phase in set-up's
build (the spans under ``index.add_items``, before the window)."""
from bench.program_spans import spans

PROGRAM = True


def read(obs):
    s = spans(obs, "wave.candidates", None, under="index.add_items")
    if s is None:
        return None
    return sum(x.seconds for x in s)
