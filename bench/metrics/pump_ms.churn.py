"""Mean host milliseconds of a ``ServingEngine.pump()`` started in the
window (the benchmark's span around each call)."""


def read(obs):
    w = obs.window
    s = obs.spans.named("pump", w["t0"], w["t1"])
    if not s:
        return None
    return 1e3 * sum(x.seconds for x in s) / len(s)
