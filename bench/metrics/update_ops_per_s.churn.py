"""Updates published in the churn cell's window over its seconds, one
update a delete and its replace: a host-paced number of a device that
idles, so a per-layer metric (read in a ``--trace 1`` run from its
untraced window)."""


def read(obs):
    w = obs.window
    if "updates" not in w or not w["window_s"]:
        return None
    return w["updates"] / w["window_s"]
