"""Host milliseconds a window second in the tau-triggered backup rebuild:
the ``backup.rebuild`` spans (the reachability sweep and the backup's
build, up to the device's sync) that started in the untraced window."""
from bench.program_spans import spans

PROGRAM = True


def read(obs):
    s = spans(obs, "backup.rebuild", obs.window)
    if s is None:
        return None
    return 1e3 * sum(x.seconds for x in s) / obs.window["window_s"]
