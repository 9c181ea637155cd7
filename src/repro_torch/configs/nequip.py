"""nequip [arXiv:2101.03164] — O(3)-equivariant interatomic potential.

n_layers=5 d_hidden=32 l_max=2 n_rbf=8 cutoff=5, E(3) tensor-product
message passing (irrep regime of the GNN kernel taxonomy).
"""
import dataclasses

from .base import GNNConfig

CONFIG = GNNConfig(
    name="nequip",
    n_layers=5,
    d_hidden=32,
    l_max=2,
    n_rbf=8,
    cutoff=5.0,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="nequip-smoke", n_layers=2, d_hidden=8, l_max=2, n_rbf=4)
