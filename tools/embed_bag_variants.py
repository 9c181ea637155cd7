#!/usr/bin/env python3
"""Time design variants of the ``embed_bag`` CUDA kernel on one GPU.

    python3 tools/embed_bag_variants.py [--out results.json]

Each variant is a copy of ``src/repro_torch/kernels/embed_bag/csrc/
embed_bag.cu`` with one change (the table's L2 policy, the id and output
streams' cache hints, L1 allocation, the row loads in flight per lane),
compiled with ``nvcc`` into ``build/embed_bag_variants/`` and loaded with
``ctypes``. One more copy takes the TPU kernel's loop order, vocabulary
slabs: the id range cut into 2-8 slabs, one pass over every bag per slab,
each gathering only its slab's rows (a slab small enough to stay in L2)
and adding to the output the passes before it wrote. All run at wide-deep's
serve_bulk shape (262,144 bags of 32 over a 1,000,000 x 32 f32 table,
``recsys_batch`` seed 1) and at 4,096 bags, are held to the plain version
(1e-4), and are timed with CUDA events over 20 launches, in four rounds of
alternating order. Prints one line per variant and the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/embed_bag/csrc/embed_bag.cu"
OUT_DIR = ROOT / "build" / "embed_bag_variants"
POLICY = 'createpolicy.fractional.L2::evict_last.b64 %0, 1.0;'
V4 = "ld.global.nc.L2::cache_hint.v4.u32"


def _sub(src: str, a: str, b: str) -> str:
    if a not in src:
        raise SystemExit(f"variant anchor not in the source: {a!r}")
    return src.replace(a, b)


def slab_variant(src: str) -> str:
    """The source with vocabulary slabs: ``embed_bag_set_slabs(n)`` makes
    each launch ``n`` passes; pass p gathers ids in [V p / n, V (p + 1) /
    n) and adds the output of the passes before it."""
    s = _sub(src, "                 int B, int L, int V, int D, int lg, "
             "int mean,\n",
             "                 int B, int L, int lo, int V, int D, int lg, "
             "int mean,\n                 int first, int last,\n")
    s = _sub(s, "jj >= 0 && jj < V)", "jj >= lo && jj < V)")
    s = _sub(s, "        if (mean) {\n",
             "        float* dst = out + (size_t)bag * D + (size_t)c * VPL;\n"
             "        if (!first)\n"
             "          for (int e = 0; e < VPL; ++e) acc[e] = __ldcs(dst + e)"
             " + acc[e];\n"
             "        if (mean && last) {\n")
    s = _sub(s, "      static_cast<const T*>(table), idx, B, L, V, D, lg, "
             "mean, out);\n  return (int)cudaGetLastError();",
             "      static_cast<const T*>(table), idx, B, L, 0, V, D, lg, "
             "mean, 1, 1, out);\n  return (int)cudaGetLastError();")
    s = _sub(s, "  embed_bag_kernel<T, VPL><<<need < room ? need : room, "
             "WARPS * 32, 0, s>>>(\n      static_cast<const T*>(table), idx,"
             " B, L, 0, V, D, lg, mean, 1, 1, out);\n",
             "  for (int p = 0; p < g_slabs; ++p) {\n"
             "    const int lo = (int)((long long)V * p / g_slabs);\n"
             "    const int hi = (int)((long long)V * (p + 1) / g_slabs);\n"
             "    embed_bag_kernel<T, VPL><<<need < room ? need : room, "
             "WARPS * 32, 0,\n                               s>>>(\n"
             "        static_cast<const T*>(table), idx, B, L, lo, hi, D, lg,"
             " mean, p == 0,\n        p == g_slabs - 1, out);\n  }\n")
    s = _sub(s, "namespace {\n", "namespace {\n\nint g_slabs = 1;\n")
    return s + ('extern "C" void embed_bag_set_slabs(int n) '
                "{ g_slabs = n; }\n")


def variants(src: str) -> dict[str, str]:
    def sub(a, b):
        return _sub(src, a, b)
    return {
        "as_is": src,
        "table_evict_normal": sub(POLICY, POLICY.replace("evict_last",
                                                         "evict_normal")),
        "table_evict_first": sub(POLICY, POLICY.replace("evict_last",
                                                        "evict_first")),
        "table_evict_last_0.4": sub(POLICY, POLICY.replace("1.0;", "0.4;")),
        "streams_cached": sub("__ldcs(idx", "__ldg(idx").replace(
            "__ldcs(ids", "__ldg(ids").replace("__stcs(", "__stwb("),
        "rows_L1_no_allocate": sub(V4, V4.replace(
            "ld.global.nc.L2", "ld.global.nc.L1::no_allocate.L2")),
        "U4": sub("constexpr int U = 8;", "constexpr int U = 4;"),
        "U16": sub("constexpr int U = 8;", "constexpr int U = 16;"),
        "slabs": slab_variant(src),
    }


def build(name: str, src: str):
    cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
    cu.write_text(src)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", "-shared", "-Xcompiler",
                        "-fPIC", "-Xptxas", "-v", "-o", str(so), str(cu)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed on {name}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.embed_bag_launch.argtypes = [p, p, i, i, i, i, i, i, i, p, p]
    lib.embed_bag_launch.restype = i
    if name == "slabs":
        lib.embed_bag_set_slabs.argtypes = [i]
    regs = [line.split(":", 1)[1].strip() for line in
            (r.stdout + r.stderr).splitlines() if "registers" in line]
    return name, lib, regs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import recsys_batch
    from repro_torch.kernels.embed_bag import embed_bag_ref

    if not torch.cuda.is_available():
        print("embed_bag_variants: no CUDA GPU available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    srcs = variants(SRC.read_text())
    with ThreadPoolExecutor(len(srcs)) as ex:
        built = list(ex.map(lambda kv: build(*kv), srcs.items()))
    for name, _, regs in built:
        print(f"{name}: ptxas {regs}", flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    V, D = 1_000_000, 32
    table = torch.tensor(rng.normal(size=(V, D)), dtype=torch.float32,
                         device=dev)
    shapes = {"serve_bulk": torch.from_numpy(recsys_batch(
        get_config("wide_deep"), 262_144, seed=1)["bag_ids"]).to(dev)}
    small = rng.integers(0, V, size=(4096, 32)).astype(np.int32)
    small[rng.random(small.shape) < 0.1] = -1
    shapes["bags_4096"] = torch.from_numpy(small).to(dev)

    cases = [(name, lib, 1) for name, lib, _ in built if name != "slabs"]
    slabs = next(lib for name, lib, _ in built if name == "slabs")
    cases += [(f"{n}_slabs", slabs, n) for n in (1, 2, 3, 4, 6, 8)]
    results = {}
    for tag, idx in shapes.items():
        idx = idx.contiguous()
        B, L = idx.shape
        ref = embed_bag_ref(table, idx)
        out = torch.empty((B, D), device=dev)

        def run(lib, n):
            if lib is slabs:
                lib.embed_bag_set_slabs(n)
            err = lib.embed_bag_launch(
                table.data_ptr(), idx.data_ptr(), B, L, V, D, 0, 1, 0,
                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"launch failed: CUDA error {err}")

        times = {name: [] for name, _, _ in cases}
        for name, lib, n in cases:
            run(lib, n)
            torch.cuda.synchronize()
            if not torch.allclose(out, ref, rtol=1e-4, atol=1e-4):
                raise SystemExit(f"{name} disagrees with the plain version")
        for rnd in range(4):
            for name, lib, n in (cases if rnd % 2 == 0 else cases[::-1]):
                run(lib, n)
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                t0.record()
                for _ in range(20):
                    run(lib, n)
                t1.record()
                torch.cuda.synchronize()
                times[name].append(t0.elapsed_time(t1) / 20)
        results[tag] = times
        for name, v in times.items():
            print(f"{tag} {name}: " + " ".join(f"{x:.4f}" for x in v)
                  + f"  min {min(v):.4f} ms", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": smi,
                                              "ms": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
