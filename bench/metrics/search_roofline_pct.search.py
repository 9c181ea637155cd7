"""The graph search's per-lane gather bytes at HBM rate, over its device
time: the time of the rows each lane visited (``rows_visited``, ``d``
elements of the configuration's dtype a row; a row that several lanes
visit counts once for each) and of each query once (f32) at the H100's
published HBM rate (``reference.roofline.HBM_BYTES_PER_S``), over the
device seconds inside the ``knn_query`` spans of the profiled window.
Lanes share rows (about 200 lanes a row a batch), so this is no least
time: a kernel that reads a shared row once, through L2 or shared memory,
could beat it. Rows from the layer-0 ``search.layer`` spans under
``index.knn_query``."""
from bench.program_spans import attr, spans
from bench.reference.roofline import HBM_BYTES_PER_S

PROGRAM = True
ROW_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def read(obs):
    dev = (obs.trace or {}).get("per_span", {}).get("knn_query")
    s = spans(obs, "search.layer", obs.traced, under="index.knn_query")
    s = [x for x in s or () if x.attrs.get("layer") == 0]
    rows = [attr(x, "rows_visited") for x in s]
    if not dev or not s or None in rows:
        return None
    t = sum(sec for sec, _ in dev)
    if t <= 0:
        return None
    cfg = obs.program.cfg
    d = cfg["d"]
    nbytes = (sum(rows) * d * ROW_BYTES[cfg["dtype"]]
              + sum(attr(x, "lanes") for x in s) * d * 4)
    return 100.0 * nbytes / HBM_BYTES_PER_S / t
