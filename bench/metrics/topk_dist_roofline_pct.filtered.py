"""``topk_dist``'s share of its roofline in the filtered batches: the least
time of the work the calls need (``reference.roofline.masked_topk_work``:
the allowed rows only, at the published H100 peaks) over the device time
of the kernels named ``topk_dist*`` in the trace."""
from bench.reference.roofline import masked_topk_work


def read(obs):
    if not obs.trace:
        return None
    w = obs.traced
    calls = obs.spans.named("filter_batch", w["t0"], w["t1"])
    t = sum(v for n, v in obs.trace["kernel_s"].items() if "topk_dist" in n)
    if not calls or t <= 0:
        return None
    least = sum(masked_topk_work(c.attrs["q"], c.attrs["n_rows"],
                                 c.attrs["allowed"], c.attrs["d"],
                                 c.attrs["k"]).least_s for c in calls)
    return 100.0 * least / t
