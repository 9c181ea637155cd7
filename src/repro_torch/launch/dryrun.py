"""Dry run: every (arch x shape) cell's step counted on a fake H100.

Each cell's step (``models.api.ArchAPI.make_step``) runs once on stand-in
tensors that hold no memory and launch nothing, under a counting dispatch
mode, ``CostMode``, which books

* the FLOPs of every product, by PyTorch's ``FlopCounterMode`` formulas
  (``torch.utils.flop_counter.flop_registry``), in families: ``matmul``
  (weight products), ``attention`` (the einsums under
  ``models._scope.family``), and each custom kernel (``topk_dist``,
  ``l2dist``, ``embed_bag``, through their custom ops' formulas); any other
  op with a formula under its own name;
* ``bytes_accessed``: every op's inputs read and outputs written, the
  views left out, an in-place scatter's rows only. No two ops are fused
  here, so this is an upper bound on the card's HBM traffic;
* the memory: each new storage's bytes (rounded to the caching
  allocator's 512-byte blocks) counted when an op makes it and freed by a
  weakref finalizer when the storage dies, so the peak includes what
  autograd saves until the backward frees it. ``per_device_bytes`` keeps
  the reference's fields: ``arguments`` (the step's inputs), ``outputs``,
  ``aliased`` (outputs that are inputs updated in place: a train step's
  parameters and moments, a decode step's cache), ``temps`` and
  ``total_peak_estimate`` = arguments + the peak of the step's own
  storages.

The card is the H100's data sheet (``CARD``): its peaks price the counts
(``roofline_ms``) and its 80 GB decide ``fits``. The stand-ins are
``meta`` tensors, with the kernels' wrappers sending them to their custom
ops' shape functions (``kernels._build.tracing``). The same mode runs over
a real step on the card (``count_step``), so a trace can be held to it:
equal FLOPs, and the peak to ``torch.cuda.max_memory_allocated``
(``chip_smoke.py``, phase 12).

The reference AOT-compiles each cell for a TPU pod and reads XLA's cost
and memory analyses; it unrolls its ``lax.scan``s to correct the trip
count (``calibration_variants``, ``_extrapolate``). The port's loops are
Python loops, every layer traced, so there is nothing to correct. One card
runs no collective and has no mesh.

Usage (no GPU needed):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch wide-deep \\
      --shape train_batch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from .._tree import tree_leaves, tree_map
from ..configs import ARCHS, get_config, shapes_for
from ..configs.base import GNNConfig, LMConfig, ShapeSpec
from ..kernels._build import tracing
from ..models import _scope
from ..models.api import ShapeDtype, StepBundle, get_api

#: NVIDIA H100 SXM5 80GB, NVIDIA's data sheet: dense peaks at 700 W
CARD = "NVIDIA H100 SXM5 80GB (data sheet, dense, 700 W)"
PEAK_FLOPS = {"bf16": 989e12, "f16": 989e12, "f32": 67e12,
              # the distance kernels' exact f32: three TF32 products each
              "f32x3": 495e12 / 3}
PEAK_BYTES = 3.35e12
HBM_BYTES = 80e9
#: kept free of the step: the CUDA context's and cuBLAS's workspaces, and
#: the caching allocator's rounding and fragmentation
RESERVE_BYTES = 4e9
BLOCK = 512               # the caching allocator's block granularity
DEFAULT_OUT = os.path.join("build", "dryrun")

_MATMULS = {torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
            torch.ops.aten.baddbmm}
_NO_DATA = {"empty", "empty_like", "new_empty", "empty_strided",
            "new_empty_strided", "_unsafe_view", "lift_fresh"}
#: in-place scatters: they read and write the rows they index, not the
#: whole of the tensor they update
_SCATTERS = {"index_put_", "_index_put_impl_", "index_add_", "scatter_",
             "scatter_add_", "index_copy_"}
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16",
                torch.float32: "f32"}


def _round(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor):
    return t.untyped_storage()


class CostMode(TorchDispatchMode):
    """Counts FLOPs, bytes and live storage bytes of everything run under
    it, real or ``meta`` tensors alike. ``args`` are the step's inputs: their
    storages count as ``arguments`` and are never new."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = defaultdict(int)          # (family, dtype) -> FLOPs
        self.bytes_accessed = 0
        self.ops = 0
        self.live = self.peak = 0
        self._args = weakref.WeakSet()
        self._seen = weakref.WeakSet()
        self.arg_bytes = 0
        for t in _tensors(args):
            s = _storage(t)
            if s not in self._args:
                self._args.add(s)
                self._seen.add(s)
                self.arg_bytes += _round(s.nbytes())
        self._entered = 0

    def __enter__(self):
        if not self._entered:
            _scope.open_count()
        self._entered += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._entered -= 1
            if not self._entered:
                _scope.close_count()

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        s = _storage(t)
        if s in self._seen:
            return
        self._seen.add(s)
        n = _round(s.nbytes())
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim":       # metadata queries (``.device``)
            return func(*args, **kwargs)
        if torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
            # reached as a whole under ``inference_mode`` (``matmul``,
            # ``einsum``): count the ops it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        self.ops += 1
        formula = flop_registry.get(packet)
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            self.flops[self._family(packet, args)] += n
        outs = _tensors(out)
        name = packet.__name__
        if name in _SCATTERS:
            self.bytes_accessed += 2 * sum(
                t.numel() * t.element_size()
                for t in _tensors((args[1:], kwargs)))
        elif not func.is_view and name not in _NO_DATA:
            self.bytes_accessed += sum(
                t.numel() * t.element_size()
                for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._track(t)
        return out

    @staticmethod
    def _family(packet, args) -> tuple:
        ins = _tensors(args)
        if packet in _MATMULS:
            name = _scope.current() or "matmul"
            dt = ins[-1].dtype
        elif packet._qualified_op_name.startswith("repro_torch::"):
            name = packet.__name__
            dt = ins[1].dtype if name != "embed_bag" else torch.float32
            if name != "embed_bag" and dt == torch.float32:
                return name, "f32x3"
        else:
            name, dt = str(packet), ins[0].dtype
        return name, _DTYPE_NAMES.get(dt, "f32")

    def result(self, out) -> dict:
        """The counts, with ``out`` (the step's outputs, still alive)
        split into the inputs it updated in place and new storages."""
        aliased = new = 0
        seen = set()
        for t in _tensors(out):
            s = _storage(t)
            if id(s) in seen:
                continue
            seen.add(id(s))
            if s in self._args:
                aliased += _round(s.nbytes())
            else:
                new += _round(s.nbytes())
        by_family = defaultdict(int)
        for (fam, _), n in self.flops.items():
            by_family[fam] += n
        return {
            "per_device_bytes": {
                "arguments": self.arg_bytes, "outputs": new + aliased,
                "temps": self.peak - new, "aliased": aliased,
                "total_peak_estimate": self.arg_bytes + self.peak},
            "cost": {
                "flops": sum(self.flops.values()),
                "flops_by_family": dict(sorted(by_family.items())),
                "flops_by_dtype": {f"{fam}:{dt}": n for (fam, dt), n in
                                   sorted(self.flops.items())},
                "bytes_accessed": self.bytes_accessed,
                "bytes_note": "every op's inputs and outputs, unfused: an "
                              "upper bound on HBM traffic",
                "ops": self.ops}}


def materialize(tree, device):
    """A tree of ``ShapeDtype`` as empty tensors on ``device``."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device=device), tree)


def shapes_of(tree):
    """A tree of tensors as the ``ShapeDtype`` tree a bundle holds."""
    return tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype)
                    if isinstance(t, torch.Tensor) else t, tree)


def count_step(fn, call_args: list) -> dict:
    """Run ``fn(*call_args)`` under ``CostMode``; the counts and the step's
    host seconds. The outputs are dropped after counting."""
    t0 = time.perf_counter()
    with CostMode(call_args) as cm:
        out = fn(*call_args)
        rec = cm.result(out)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def call_shapes(api, bundle: StepBundle) -> list:
    """The abstract arguments of ``bundle.fn``: parameters, the optimizer
    state where the step takes it, then the bundle's own."""
    args = [api.param_shapes()]
    if bundle.with_opt:
        args.append(api.opt_shapes())
    return args + list(bundle.args)


def trace_step(fn, shapes: list) -> dict:
    """``count_step`` over ``meta`` stand-ins of ``shapes``."""
    with tracing():
        return count_step(fn, materialize(shapes, "meta"))


def arg_bytes(shapes) -> int:
    return sum(_round(s.nbytes) for _, s in tree_leaves(shapes))


# ---------------------------------------------------------------------------
# what a cell needs, analytically
# ---------------------------------------------------------------------------

def model_flops(cfg, sh: ShapeSpec) -> float:
    """Analytic useful FLOPs of one step: the reference's roofline
    formula (its ``benchmarks/roofline.py``), on one card."""
    if isinstance(cfg, LMConfig):
        n_active = cfg.active_param_count()
        tokens = sh.global_batch * sh.seq_len
        if sh.kind == "train":
            return 6.0 * n_active * tokens          # fwd 2ND + bwd 4ND
        if sh.kind == "prefill":
            return 2.0 * n_active * tokens
        # decode: one token per sequence + attention reads over the cache
        attn = (2.0 * cfg.num_layers * sh.global_batch * sh.seq_len
                * cfg.num_heads * cfg.head_dim * 2)
        return 2.0 * n_active * sh.global_batch + attn
    if isinstance(cfg, GNNConfig):
        # per edge x layer: tensor-product paths + radial MLPs (x3 for train)
        from ..models.e3 import paths
        mul = cfg.d_hidden
        per_edge = 0
        for (l1, lf, lo) in paths(cfg.l_max):
            per_edge += 2 * mul * (2 * l1 + 1) * (2 * lf + 1) * (2 * lo + 1)
            per_edge += 2 * (cfg.n_rbf * 16 + 16 * mul)
        edges = sh.n_edges * max(sh.graph_batch, 1)
        if sh.name == "minibatch_lg":
            s = sh.batch_nodes
            edges = s * sh.fanout[0] * (1 + sh.fanout[1])
        nodes = sh.n_nodes * max(sh.graph_batch, 1)
        per_node = 2 * (cfg.l_max + 1) * mul * mul * 2 * 3  # linears
        return 3.0 * cfg.n_layers * (edges * per_edge + nodes * per_node)
    B = sh.batch
    if sh.kind == "retrieval":
        return 2.0 * B * sh.n_candidates * cfg.embed_dim
    D = cfg.embed_dim
    if cfg.kind == "wide_deep":
        dims = ((cfg.n_sparse + 1) * D, *cfg.mlp, 1)
        f = sum(2 * a * b for a, b in zip(dims, dims[1:]))
    elif cfg.kind == "autoint":
        f = cfg.n_attn_layers * (
            3 * 2 * D * cfg.n_heads * cfg.d_attn * cfg.n_sparse
            + 2 * cfg.n_sparse ** 2 * cfg.n_heads * cfg.d_attn * 2)
    elif cfg.kind == "dien":
        f = cfg.seq_len * 2 * 3 * (D + cfg.gru_dim) * cfg.gru_dim * 2
    else:  # sasrec
        f = cfg.n_blocks * (4 * 2 * D * D * cfg.seq_len
                            + 2 * cfg.seq_len ** 2 * D * 2)
    return (3.0 if sh.kind == "train" else 1.0) * B * f


def param_counts(api) -> tuple[int, int]:
    """``(param_count, active_param_count)``: the LM config's own figures
    (the reference's), else every leaf of the tree, all active."""
    cfg = api.config
    if hasattr(cfg, "param_count"):
        return int(cfg.param_count()), int(cfg.active_param_count())
    n = sum(math.prod(s.shape) for _, s in tree_leaves(api.param_shapes()))
    return n, n


def roofline_ms(cost: dict) -> dict:
    """The least time of the counted work on the card: each product's
    FLOPs at the dense peak of its dtype, the unfused bytes at HBM rate."""
    compute = sum(n / PEAK_FLOPS[key.rsplit(":", 1)[1]]
                  for key, n in cost["flops_by_dtype"].items()) * 1e3
    memory = cost["bytes_accessed"] / PEAK_BYTES * 1e3
    return {"compute": compute, "memory": memory,
            "bound": "compute" if compute >= memory else "memory",
            "ms": max(compute, memory), "card": CARD}


def fits(total_peak: int) -> bool:
    return total_peak <= HBM_BYTES - RESERVE_BYTES


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _batch_field(cfg, sh: ShapeSpec) -> str | None:
    """The shape's batch axis, or None (a full graph, one sampled
    subgraph)."""
    if isinstance(cfg, LMConfig):
        return "global_batch"
    if isinstance(cfg, GNNConfig):
        return "graph_batch" if sh.graph_batch else None
    return "batch"


def _bundle(cfg, sh: ShapeSpec):
    api = get_api(cfg)
    bundle = api.make_step(sh)
    return bundle.api or api, bundle


def probe(cfg, sh: ShapeSpec) -> bool:
    """Whether the step at ``sh`` fits the card: its arguments alone, else
    a trace."""
    api, bundle = _bundle(cfg, sh)
    shapes = call_shapes(api, bundle)
    if not fits(arg_bytes(shapes)):
        return False
    return fits(trace_step(bundle.fn, shapes)["per_device_bytes"]
                ["total_peak_estimate"])


def largest_fitting_batch(cfg, sh: ShapeSpec, fits_at_cell: bool):
    """The largest power of two <= the cell's batch at which the step fits
    on the fake card (0: none does), by halving the range of exponents;
    None for a shape without a batch axis."""
    field = _batch_field(cfg, sh)
    if field is None:
        return None
    B = getattr(sh, field)
    top = B.bit_length() - 1
    if fits_at_cell and B == 1 << top:
        return B
    api, bundle = _bundle(cfg, dataclasses.replace(sh, **{field: 1}))
    if not fits(arg_bytes(call_shapes(api, bundle))):
        return 0                       # the parameters alone do not fit
    lo, hi = -1, top if B != 1 << top else top - 1   # answer in [lo, hi]
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if probe(cfg, dataclasses.replace(sh, **{field: 1 << mid})):
            lo = mid
        else:
            hi = mid - 1
    return 0 if lo < 0 else 1 << lo


def run_cell(arch: str, shape_name: str, search: bool = True) -> dict:
    """Trace one cell (and search its largest fitting batch): the record
    ``main`` writes."""
    cfg = get_config(arch)
    sh = shapes_for(cfg)[shape_name]
    api, bundle = _bundle(cfg, sh)
    rec = trace_step(bundle.fn, call_shapes(api, bundle))
    n, n_active = param_counts(api)
    peak = rec["per_device_bytes"]["total_peak_estimate"]
    out = {"arch": arch, "shape": shape_name, "step": bundle.name,
           "seconds": rec.pop("seconds"), **rec,
           "param_count": n, "active_param_count": n_active,
           "model_flops": model_flops(api.config, sh),
           "roofline_ms": roofline_ms(rec["cost"]),
           "fits": fits(peak), "fit_budget_bytes": HBM_BYTES - RESERVE_BYTES}
    if search:
        t0 = time.perf_counter()
        out["largest_fitting_batch"] = largest_fitting_batch(cfg, sh,
                                                             out["fits"])
        out["search_seconds"] = time.perf_counter() - t0
    return out


def cells(arch: str | None = None, shape: str | None = None) -> list:
    """``(arch, shape)`` pairs: every cell, or ``arch``'s (spelled as the
    reference's CLI takes it, ``yi-9b``, ``codeqwen1.5-7b``, or as the
    registry does), or one."""
    archs = ARCHS if arch is None else [
        arch.replace("-", "_").replace("1.5", "15")]
    return [(a, s) for a in archs for s in shapes_for(get_config(a))
            if shape is None or s == shape]


def summary(rec: dict) -> str:
    c, pb = rec["cost"], rec["per_device_bytes"]
    lfb = rec.get("largest_fitting_batch", "cut")
    return (f"{rec['arch']:22s} {rec['shape']:14s} "
            f"counted={c['flops'] / 1e12:10.3f} TFLOP "
            f"model={rec['model_flops'] / 1e12:10.3f} TFLOP "
            f"bytes={c['bytes_accessed']:.4e} "
            f"peak={pb['total_peak_estimate'] / 1e9:8.2f} GB "
            f"fits={'yes' if rec['fits'] else 'no '} "
            f"roofline={rec['roofline_ms']['ms']:.4g} ms "
            f"({rec['roofline_ms']['bound']}) "
            f"largest_batch={lfb} trace={rec['seconds']:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-search", action="store_true",
                    help="skip the largest-fitting-batch search")
    args = ap.parse_args(argv)

    todo = cells(None if (args.all or args.arch is None) else args.arch,
                 args.shape)
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, sname in todo:
        fname = os.path.join(args.out, f"dryrun_h100_{arch}_{sname}.json")
        if args.skip_existing and os.path.exists(fname):
            print(f"[skip] {arch} {sname}")
            continue
        try:
            rec = run_cell(arch, sname, search=not args.no_search)
            with open(fname, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"[ok]   {summary(rec)}", flush=True)
        except Exception as e:
            failures.append((arch, sname, repr(e)))
            print(f"[FAIL] {arch} {sname}: {e}", flush=True)
            traceback.print_exc()
    print(f"\n{len(failures)} failures")
    for f in failures:
        print("  ", f)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
