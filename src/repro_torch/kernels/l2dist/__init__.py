from .ops import l2dist
from .ref import l2dist_ref

__all__ = ["l2dist", "l2dist_ref"]
