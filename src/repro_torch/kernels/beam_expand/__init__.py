from .ops import beam_expand
from .ref import beam_expand_ref

__all__ = ["beam_expand", "beam_expand_ref"]
