"""Host milliseconds a window second in the engine's maintenance step
(``ServingEngine._maybe_maintain``; the benchmark's span around each
call). In the churn mix no pass runs (each replace refills the slot its
delete freed), so this is the time of the health consult alone."""


def read(obs):
    w = obs.window
    s = obs.spans.named("maintain", w["t0"], w["t1"])
    if not s:
        return None
    return 1e3 * sum(x.seconds for x in s) / w["window_s"]
