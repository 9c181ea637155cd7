"""Share of the window's filtered batches that the planner sent to the
exact tier: ``topk_dist``'s launch counter over the batches sent."""


def read(obs):
    b = obs.window.get("batches")
    if not b:
        return None
    return 100.0 * obs.counters["topk_dist_launches"] / b
