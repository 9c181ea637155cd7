"""Hand-written Hopper kernels of the port (CUDA C++, ``sm_90a``).

  l2dist    — the dense pairwise distance matrix ``[Q, N]`` in form
              ``"l2"`` (squared L2, clamped at 0) or ``"ip"`` (``1 - <x, y>``),
              f32 or bf16 inputs, f32 accumulation;
  topk_dist — streaming masked distance + running top-k, the exact scan
              tier behind ``exact_scan`` and the brute-force ground truth;
  embed_bag — EmbeddingBag: a direct gather and f32 segment sum (``sum`` /
              ``mean``, ``-1`` = padding);
  beam_expand — one expansion step of the lockstep beam search: the
              expanded rows' neighbours, their visited test-and-set and
              the distances to the fresh rows only;
  count_flags — the set flags of a bool matrix's first columns (the rows
              the lockstep search visited, counted while a profiler
              records).

Each package ships the launcher (``<name>.py``; ``_build.py`` compiles the
CUDA source at first use), ``ops.py`` (checks and dispatch: the kernel for
CUDA tensors, the plain version for CPU tensors, a ``launches`` count) and
``ref.py`` (plain PyTorch).
"""
from .beam_expand import beam_expand
from .count_flags import count_flags
from .embed_bag import embed_bag
from .l2dist import l2dist
from .topk_dist import topk_dist

__all__ = ["l2dist", "topk_dist", "embed_bag", "count_flags", "beam_expand"]
