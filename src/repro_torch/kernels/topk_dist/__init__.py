from .ops import topk_dist
from .ref import topk_dist_ref

__all__ = ["topk_dist", "topk_dist_ref"]
