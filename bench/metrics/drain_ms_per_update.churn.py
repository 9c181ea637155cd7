"""Host milliseconds in ``UpdateScheduler.drain`` (the wave executor, the
benchmark's span around each call) per update published in the window."""


def read(obs):
    w = obs.window
    s = obs.spans.named("drain", w["t0"], w["t1"])
    if not s or not w.get("updates"):
        return None
    return 1e3 * sum(x.seconds for x in s) / w["updates"]
