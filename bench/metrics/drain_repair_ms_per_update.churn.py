"""Host milliseconds of the wave executor's ``wave.repair`` phase inside
``scheduler.drain`` in the untraced window, per update published."""
from bench.program_spans import spans

PROGRAM = True


def read(obs):
    w = obs.window
    s = spans(obs, "wave.repair", w, under="scheduler.drain")
    if s is None or not w.get("updates"):
        return None
    return 1e3 * sum(x.seconds for x in s) / w["updates"]
