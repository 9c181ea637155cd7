from .ops import EmbedBagFunction, embed_bag
from .ref import embed_bag_backward_ref, embed_bag_ref

__all__ = ["embed_bag", "embed_bag_ref", "embed_bag_backward_ref",
           "EmbedBagFunction"]
