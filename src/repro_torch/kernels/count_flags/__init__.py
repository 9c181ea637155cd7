from .ops import count_flags
from .ref import count_flags_ref

__all__ = ["count_flags", "count_flags_ref"]
