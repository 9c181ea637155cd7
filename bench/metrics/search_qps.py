"""Queries answered in a closed-loop window over the window's seconds
(every batch sent in the window, the last one's answer closing it)."""


def read(obs):
    w = obs.window
    if "batches" not in w or not w["window_s"]:
        return None
    return w["queries"] / w["window_s"]
