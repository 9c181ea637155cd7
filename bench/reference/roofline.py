"""The least time of a kernel call on one H100, from the work it needs.

Peaks are NVIDIA's published H100 SXM figures (dense, at the full 700 W
power limit): 495 TFLOP/s in TF32 and 3.35 TB/s of HBM3. ``topk_dist``
contracts float32 inputs as 3xTF32 (three TF32 products per float32
product), so its float32 contraction is priced at 495 / 3 TFLOP/s. A card
set below 700 W runs slower: the power limit is recorded beside every
share.
"""
from __future__ import annotations

import dataclasses

TF32_FLOPS = 495e12
TF32X3_FLOPS = TF32_FLOPS / 3
HBM_BYTES_PER_S = 3.35e12
#: the power limit the peaks assume
PEAK_WATTS = 700.0


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    bytes: float

    @property
    def least_s(self) -> float:
        """The larger of the compute and the memory bound."""
        return max(self.flops / TF32X3_FLOPS, self.bytes / HBM_BYTES_PER_S)

    @property
    def bound_by(self) -> str:
        return ("flops" if self.flops / TF32X3_FLOPS
                >= self.bytes / HBM_BYTES_PER_S else "bytes")


def masked_topk_work(q: int, n_rows: int, allowed: int, d: int, k: int,
                     row_bytes: int = 4) -> Work:
    """What a masked ``topk_dist`` call over ``n_rows`` candidates needs
    when ``allowed`` of them pass its mask: the distances of each query to
    the allowed rows (``2 q allowed d`` FLOPs) and each byte read or
    written once: the allowed rows, the queries (f32), the mask (one byte
    a row) and the outputs (an f32 distance and an i32 id each). Rows the
    mask excludes are work no answer needs, so they are not counted."""
    flops = 2.0 * q * allowed * d
    nbytes = (allowed * d * row_bytes + q * d * 4 + n_rows
              + q * k * (4 + 4))
    return Work(flops, nbytes)


def power_limit_watts() -> float | None:
    """The first card's power limit as ``nvidia-smi`` reads it, or None."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    try:
        return float(out.stdout.split()[0])
    except (IndexError, ValueError):
        return None
