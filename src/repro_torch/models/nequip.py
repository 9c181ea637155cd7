"""NequIP [arXiv:2101.03164]: O(3)-equivariant interatomic potential, as
the reference's ``models/nequip.py``.

Message passing over an edge list (src -> dst): per path (l_in, l_f -> l_out)

    m_e = R_path(rbf(|r_e|)) * CG-contract( h_src[l_in] (x) Y_{l_f}(r_hat_e) )

summed into each destination node by ``index_add_`` in f32 (the
reference's ``segment_sum``), then a per-l linear self-interaction and a
gated nonlinearity. Features are a dict ``{l: [N, mul, 2l+1]}``; the
energy is the sum of per-atom scalars, and the forces are
``-dE/dpositions`` by ``torch.autograd``. Each interaction runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so a
backward keeps one layer's edge messages at a time.

Parameters are the reference's tree (``params["layers"]`` stacked
``[L, ...]``, the radial MLPs keyed by the path's digits ``"{l1}{lf}{lo}"``)
with the reference's scales, drawn from the port's own generator;
``models.convert.gnn_params_from_reference`` carries the reference's. The
CG tensors come from ``e3.real_cg`` unless ``cg=`` gives a table of them
(the parity tests hand over the reference's, whose signs on four paths
depend on its call order; ``e3``).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import GNNConfig
from ..core.common import has_data
from ._params import Leaf, draw_tree, normal_generator
from .e3 import paths, real_cg, sh_torch

RADIAL_HIDDEN = 16


def bessel_basis(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Bessel radial basis with smooth polynomial cutoff envelope."""
    r = torch.clamp(r, min=1e-9)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    b = math.sqrt(2.0 / cutoff) * torch.sin(n * math.pi * r[..., None]
                                            / cutoff) / r[..., None]
    x = torch.clamp(r / cutoff, 0, 1)
    env = 1 - 10 * x**3 + 15 * x**4 - 6 * x**5          # C^2 smooth at cutoff
    return b * env[..., None]


def param_spec(cfg: GNNConfig) -> dict:
    """The reference's tree: linear maps N(0, 1) / sqrt(fan-in), the
    species embedding N(0, 1) x 0.5, every layer's leaf stacked ``[L, ...]``."""
    mul, L = cfg.d_hidden, cfg.n_layers
    ls = range(cfg.l_max + 1)

    def lin(n_in, n_out, stack=()):
        return Leaf((*stack, n_in, n_out), torch.float32, "normal",
                    1 / math.sqrt(n_in))
    spec: dict = {"species_embed": Leaf((cfg.n_species, mul), torch.float32,
                                        "normal", 0.5)}
    if cfg.d_feat:
        spec["feat_proj"] = lin(cfg.d_feat, mul)
    n_gated = cfg.l_max
    spec["layers"] = {
        "radial": {f"{l1}{lf}{lo}": {"w1": lin(cfg.n_rbf, RADIAL_HIDDEN, (L,)),
                                     "w2": lin(RADIAL_HIDDEN, mul, (L,))}
                   for (l1, lf, lo) in paths(cfg.l_max)},
        "lin_out": {str(l): lin(mul, mul + (mul * n_gated if l == 0 else 0),
                                (L,)) for l in ls},
        "self": {str(l): lin(mul, mul + (mul * n_gated if l == 0 else 0),
                             (L,)) for l in ls},
    }
    spec["energy_head"] = {"w1": lin(mul, RADIAL_HIDDEN),
                           "w2": lin(RADIAL_HIDDEN, 1)}
    return spec


def init_params(cfg: GNNConfig, generator: torch.Generator | None = None, *,
                seed: int = 0, device="cuda") -> dict:
    """The reference's initialisation (tree, shapes and scales), drawn from
    ``generator`` (default: a generator on ``device`` seeded with
    ``seed``); the draws are the port's own, not the reference's stream."""
    gen, dev = normal_generator(generator, seed, device)
    return draw_tree(param_spec(cfg), gen, dev)


@functools.lru_cache(maxsize=None)
def _real_cg_on(path: tuple, device: torch.device) -> torch.Tensor:
    """``e3.real_cg(*path)`` in f32 on ``device``, copied there once."""
    return torch.as_tensor(real_cg(*path), dtype=torch.float32,
                           device=device)


def _cg_table(cfg: GNNConfig, cg, like: torch.Tensor) -> dict:
    """Each path's CG tensor on ``like``'s device: ``cg[path]`` where
    given, else ``e3.real_cg`` (its device copy cached, except for a dry
    run's stand-ins, which must not outlive the trace)."""
    cg = cg or {}
    device = like.device
    real = _real_cg_on if has_data(like) else _real_cg_on.__wrapped__
    return {p: (torch.as_tensor(cg[p], dtype=torch.float32, device=device)
                if p in cg else real(p, device))
            for p in paths(cfg.l_max)}


def _unstack(tree, i):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def _interaction(cfg: GNNConfig, lp: dict, cgs: dict, feats: dict, src, dst,
                 rhat, rbf, edge_mask, n_nodes: int) -> dict:
    mul = cfg.d_hidden
    ls = list(range(cfg.l_max + 1))
    agg = {l: torch.zeros((n_nodes, mul, 2 * l + 1), dtype=torch.float32,
                          device=rbf.device) for l in ls}
    sh_cache = {lf: sh_torch(lf, rhat) for lf in ls}
    for (l1, lf, lo), C in cgs.items():
        rp = lp["radial"][f"{l1}{lf}{lo}"]
        R = F.silu(rbf @ rp["w1"]) @ rp["w2"]                     # [E, mul]
        h_src = feats[l1][src]                                    # [E, mul, i]
        Y = sh_cache[lf]                                          # [E, j]
        m = torch.einsum("emi,ej,ijk->emk", h_src, Y, C)          # [E, mul, k]
        m = m * (R * edge_mask[:, None])[..., None]
        agg[lo] = agg[lo].index_add(0, dst, m)
    # linear mixing + self connection, then gate nonlinearity
    out = {l: torch.einsum("nmi,mk->nki", agg[l], lp["lin_out"][str(l)])
           + torch.einsum("nmi,mk->nki", feats[l], lp["self"][str(l)])
           for l in ls}
    scal = out[0][..., 0]                                         # [N, mul+g]
    new = {0: F.silu(scal[:, :mul])[..., None]}
    gates = torch.sigmoid(scal[:, mul:])                          # [N, g*mul]
    for gi, l in enumerate(ls[1:]):
        new[l] = out[l] * gates[:, gi * mul:(gi + 1) * mul, None]
    return new


def forward(cfg: GNNConfig, params: dict, batch: dict, cg=None
            ) -> torch.Tensor:
    """Returns per-graph energies [n_graphs] (f32).

    batch: positions [N,3], species [N], node_feats [N,df] (optional),
    src/dst [E], edge_mask [E], node_mask [N], graph_id [N], n_graphs.
    A self-loop or any edge of length <= 1e-6 is masked out: it has no
    direction, and its l > 0 harmonics would break equivariance.
    """
    pos = batch["positions"].float()
    src = batch["src"].long().clamp(min=0)
    dst = batch["dst"].long().clamp(min=0)
    n_nodes = pos.shape[0]
    mul = cfg.d_hidden

    rij = pos[dst] - pos[src]                                     # [E, 3]
    r = torch.linalg.norm(rij + 1e-12, dim=-1)
    rhat = rij / (r[:, None] + 1e-12)
    edge_mask = batch["edge_mask"].float() * (r > 1e-6)
    rbf = bessel_basis(r, cfg.n_rbf, cfg.cutoff)                  # [E, n_rbf]

    h0 = params["species_embed"][batch["species"].long().clamp(min=0)]
    if cfg.d_feat and "node_feats" in batch:
        h0 = h0 + batch["node_feats"].float() @ params["feat_proj"]
    feats = {0: h0[..., None]}
    for l in range(1, cfg.l_max + 1):
        feats[l] = torch.zeros((n_nodes, mul, 2 * l + 1), dtype=torch.float32,
                               device=pos.device)
    cgs = _cg_table(cfg, cg, pos)
    for i in range(cfg.n_layers):
        feats = checkpoint(_interaction, cfg, _unstack(params["layers"], i),
                           cgs, feats, src, dst, rhat, rbf, edge_mask,
                           n_nodes, use_reentrant=False)

    head = params["energy_head"]
    e_atom = F.silu(feats[0][..., 0] @ head["w1"]) @ head["w2"]   # [N, 1]
    e_atom = e_atom[:, 0] * batch["node_mask"].float()
    gid = batch["graph_id"].long().clamp(min=0)
    return torch.zeros(int(batch["n_graphs"]), dtype=torch.float32,
                       device=pos.device).index_add(0, gid, e_atom)


def energy_and_forces(cfg: GNNConfig, params: dict, batch: dict, cg=None):
    """``(E, F)``: the total energy over every graph, and the forces
    ``-dE/dpositions [N, 3]``."""
    pos = batch["positions"].float().detach().requires_grad_()
    with torch.enable_grad():
        e = forward(cfg, params, {**batch, "positions": pos}, cg=cg).sum()
        (grad,) = torch.autograd.grad(e, pos)
    return e.detach(), -grad


def loss_fn(cfg: GNNConfig, params: dict, batch: dict, cg=None):
    """Mean squared energy error: ``(loss, {"loss", "rmse"})``."""
    e = forward(cfg, params, batch, cg=cg)
    loss = torch.mean((e - batch["energy_target"]) ** 2)
    return loss, {"loss": loss, "rmse": torch.sqrt(loss)}
