#!/usr/bin/env python3
"""Where the cycles go inside the port's ``topk_dist`` and ``l2dist`` kernels.

    python3 tools/kernel_phases.py [--n 1048576]

``torch.profiler`` times a kernel as a whole; this script looks inside. It
copies ``src/repro_torch/kernels/{_csrc,topk_dist/csrc,l2dist/csrc}`` to
``build/phases/`` with ``clock64()`` counters inserted at fixed points
(the script fails if a point is missing from the sources), builds the copies
with the port's builder, and runs them through the port's wrappers at the
main-path shape (64 queries x N x 128, f32 and bf16, k = 1 and 10). It prints,
per block and averaged over its warps, the cycles of each phase of the slice
loop (``contract::run``) and of ``topk_dist``'s tile epilogue, and the
survivors of the k-th test per query per block. The counters cost time
themselves: the script prints the instrumented and the plain kernels' times
side by side. Needs a CUDA GPU and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels"
OUT = ROOT / "build" / "phases" / "kernels"

RUN_PHASES = ("wait for the slice", "mma issue", "release + next load",
              "mma results (add)", "tile epilogue")
EPI_PHASES = ("barrier 1", "k-th test", "barrier 2", "merge (flush)")

# (file, anchor, replacement): each anchor must occur exactly once
POINTS = [
    ("_csrc/contract.cuh", "namespace contract {\n",
     "namespace contract {\n__device__ unsigned long long g_run[41];\n"),
    ("_csrc/contract.cuh", """  Frag f;
  for (int i = 0; i < total; ++i) {
    const int st = i % stages, s = i % S;
    mbar_wait(R.full + st, (i / stages) & 1);
""", """  Frag f;
  long long P[5] = {0, 0, 0, 0, 0}, c0 = clock64(), c1;
  for (int i = 0; i < total; ++i) {
    const int st = i % stages, s = i % S;
    mbar_wait(R.full + st, (i / stages) & 1);
    c1 = clock64(); P[0] += c1 - c0; c0 = c1;
"""),
    ("_csrc/contract.cuh", """                 ys, norms, wm, wn, g, tq);
    __syncwarp();""", """                 ys, norms, wm, wn, g, tq);
    c1 = clock64(); P[1] += c1 - c0; c0 = c1;
    __syncwarp();"""),
    ("_csrc/contract.cuh", """    if (tid == 0 && i + stages - 2 < total) produce(i + stages - 2);
    f.add_acc();
    if (s == S - 1) epi(t_begin + i / S, f);
  }
""", """    if (tid == 0 && i + stages - 2 < total) produce(i + stages - 2);
    c1 = clock64(); P[2] += c1 - c0; c0 = c1;
    f.add_acc();
    if (f.dot[0][0][0] == 1234.5f && f.dot[1][3][3] == 1234.5f)
      asm volatile("trap;");   // waits for the mma results here
    c1 = clock64(); P[3] += c1 - c0; c0 = c1;
    if (s == S - 1) epi(t_begin + i / S, f);
    c1 = clock64(); P[4] += c1 - c0; c0 = c1;
  }
  if (lane == 0)
    for (int p = 0; p < 5; ++p)
      atomicAdd(&g_run[5 * warp + p], (unsigned long long)P[p]);
  if (tid == 0) atomicAdd(&g_run[40], 1ull);
"""),
    ("topk_dist/csrc/topk_dist.cu", "namespace {\n\nusing namespace contract;",
     "namespace {\n__device__ unsigned long long g_epi[34];\n"
     "using namespace contract;"),
    ("topk_dist/csrc/topk_dist.cu", """    if (l2) f.norms(yv, tq);
    __syncthreads();   // the last flush is done: fresh k-th, empty buffers
""", """    long long c0 = clock64(), c1;
    if (l2) f.norms(yv, tq);
    __syncthreads();   // the last flush is done: fresh k-th, empty buffers
    c1 = clock64();
    if (lane == 0) atomicAdd(&g_epi[4 * warp], (unsigned long long)(c1 - c0));
    c0 = c1;
"""),
    ("topk_dist/csrc/topk_dist.cu",
     "              const int slot = atomicAdd(cnt + r, 1);",
     "              const int slot = atomicAdd(cnt + r, 1);\n"
     "              atomicAdd(&g_epi[33], 1ull);"),
    ("topk_dist/csrc/topk_dist.cu", """    __syncthreads();
    flush();
  }""", """    c1 = clock64();
    if (lane == 0)
      atomicAdd(&g_epi[4 * warp + 1], (unsigned long long)(c1 - c0));
    c0 = c1;
    __syncthreads();
    c1 = clock64();
    if (lane == 0)
      atomicAdd(&g_epi[4 * warp + 2], (unsigned long long)(c1 - c0));
    c0 = c1;
    flush();
    __syncwarp();
    c1 = clock64();
    if (lane == 0)
      atomicAdd(&g_epi[4 * warp + 3], (unsigned long long)(c1 - c0));
  }"""),
    ("topk_dist/csrc/topk_dist.cu", "  if (tid == 0) R.init();",
     "  if (tid == 0) { R.init(); atomicAdd(&g_epi[32], 1ull); }"),
]

READER = """
extern "C" int phases_read(unsigned long long* out, int n, int which) {
  cudaDeviceSynchronize();
  unsigned long long z[41] = {0};
  cudaError_t e = which == 0
      ? cudaMemcpyFromSymbol(out, contract::g_run, sizeof(z))
      : cudaMemcpyFromSymbol(out, %s, sizeof(unsigned long long) * n);
  if (e == cudaSuccess)
    e = which == 0 ? cudaMemcpyToSymbol(contract::g_run, z, sizeof(z))
                   : cudaMemcpyToSymbol(%s, z, sizeof(unsigned long long) * n);
  return (int)e;
}
"""


def instrument() -> None:
    if OUT.exists():
        shutil.rmtree(OUT)
    for rel in ("_csrc/contract.cuh", "topk_dist/csrc/topk_dist.cu",
                "l2dist/csrc/l2dist.cu"):
        (OUT / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(SRC / rel, OUT / rel)
    for rel, anchor, new in POINTS:
        text = (OUT / rel).read_text()
        if text.count(anchor) != 1:
            raise SystemExit(f"kernel_phases: anchor not found once in {rel}:"
                             f"\n{anchor}")
        (OUT / rel).write_text(text.replace(anchor, new))
    for rel, sym in (("topk_dist/csrc/topk_dist.cu", "g_epi"),
                     ("l2dist/csrc/l2dist.cu", "contract::g_run")):
        path = OUT / rel
        path.write_text(path.read_text() + READER % (sym, sym))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._build import Library, build_all
    from repro_torch.kernels.l2dist import l2dist
    from repro_torch.kernels.topk_dist import topk_dist
    tkm = importlib.import_module("repro_torch.kernels.topk_dist.topk_dist")
    l2m = importlib.import_module("repro_torch.kernels.l2dist.l2dist")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())

    instrument()
    hdr = (OUT / "_csrc" / "contract.cuh",)
    plain = (tkm.LIBRARY, l2m.LIBRARY)
    timed = (Library("topk_dist_phases",
                     OUT / "topk_dist" / "csrc" / "topk_dist.cu",
                     tkm._configure, hdr),
             Library("l2dist_phases", OUT / "l2dist" / "csrc" / "l2dist.cu",
                     l2m._configure, hdr))
    build_all([*plain, *timed])
    for lib in timed:
        lib.lib.phases_read.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int]

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    Q = torch.tensor(rng.normal(size=(64, 128)), dtype=torch.float32,
                     device=dev)
    Y = torch.tensor(rng.normal(size=(args.n, 128)), dtype=torch.float32,
                     device=dev)
    mask = torch.tensor(rng.random(args.n) > 0.01, device=dev)
    Qb, Yb = Q.bfloat16(), Y.bfloat16()
    cases = {"topk_dist k=10 masked": lambda: topk_dist(Q, Y, 10, mask=mask),
             "topk_dist k=1": lambda: topk_dist(Q, Y, 1),
             "l2dist f32 l2": lambda: l2dist(Q, Y),
             "l2dist f32 ip": lambda: l2dist(Q, Y, metric="ip"),
             "l2dist bf16 l2": lambda: l2dist(Qb, Yb)}

    def ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    for name, fn in cases.items():
        tkm.LIBRARY, l2m.LIBRARY = plain
        t_plain = ms(fn)
        tkm.LIBRARY, l2m.LIBRARY = timed
        t_timed = ms(fn)
        lib = timed[0] if name.startswith("topk") else timed[1]
        run = (ctypes.c_ulonglong * 41)()
        epi = (ctypes.c_ulonglong * 34)()
        lib.lib.phases_read(run, 41, 0)           # reset
        if lib is timed[0]:
            lib.lib.phases_read(epi, 34, 1)
        fn()
        torch.cuda.synchronize()
        lib.lib.phases_read(run, 41, 0)
        blocks = run[40]
        row = {"ms_plain": t_plain, "ms_instrumented": t_timed,
               "blocks": blocks,
               "run_cycles_per_block": {
                   p: sum(run[5 * w + i] for w in range(8)) / 8 / blocks
                   for i, p in enumerate(RUN_PHASES)}}
        if lib is timed[0]:
            lib.lib.phases_read(epi, 34, 1)
            row["epilogue_cycles_per_block"] = {
                p: sum(epi[4 * w + i] for w in range(8)) / 8 / epi[32]
                for i, p in enumerate(EPI_PHASES)}
            row["survivors_per_query_per_block"] = epi[33] / epi[32] / 64
        print(name, json.dumps(row))
    tkm.LIBRARY, l2m.LIBRARY = plain
    return 0


if __name__ == "__main__":
    sys.exit(main())
