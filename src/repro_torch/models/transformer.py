"""Dense + MoE decoder-only LM: GQA, RoPE, RMSNorm, SwiGLU; serving and
training.

The same model as the JAX reference's ``models/transformer.py`` for all
five LM configs (codeqwen, yi, stablelm, and the MoE configs granite-moe
and deepseek-moe), with its stacked parameter layout: every per-layer
weight is one ``[L, ...]`` tensor under ``params["layers"]`` (and, for a
MoE config with leading dense layers, ``params["dense_layers"]``), so
weights carry across as a tree map (``models.convert``). The forward
follows the dtype of the parameters as the reference's does: ``rmsnorm``
and ``rope`` compute in f32 and cast back, attention scores are taken in
f32 and the probabilities cast back, the router's logits and the logits
are f32. Only ``init_cache`` fixes a dtype (``COMPUTE_DTYPE``).

MoE: capacity-based sort dispatch, as the reference's. ``_moe_route``
ranks each (token, choice) within its expert by a stable sort, so an
expert past its capacity ``C`` drops the later tokens; ``_moe_apply``
gathers the kept tokens into an ``[E*C, D]`` buffer (its backward is one
scatter-add), runs the experts as batched products and combines. Under
``dist_ctx.use_mesh`` (a ``[data][model]`` grid of devices,
``launch.mesh.make_grid``) ``moe_ffn`` runs the reference's ``shard_map``
form in one process: a capacity per data block, the experts (or every
expert's FFN columns) split over ``model`` and the slices summed.
``moe_ffn_ref`` is a plain per-expert loop of the same function, for the
tests and the smoke only.

Training: ``lm_loss`` is the reference's causal LM loss plus 0.01 x the
MoE balance loss, its cross-entropy over ``CE_CHUNK``-token chunks each
under a checkpoint, so the ``[B, S, V]`` logits are never whole;
``remat=True`` checkpoints each layer, dense or MoE
(``torch.utils.checkpoint``, nothing saved inside a layer, as the
reference's ``jax.checkpoint(nothing_saveable)``).

Not ported here: the GSPMD sharding specs and ``act_spec`` (the port has
no mesh of that kind).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import LMConfig
from ._params import Leaf, draw_tree, normal_generator
from ._scope import family
from .recsys import topk_lowest_index

COMPUTE_DTYPE = torch.bfloat16
Q_CHUNK = 512   # query-block size for memory-bounded attention
CE_CHUNK = 256  # sequence chunk for the memory-bounded CE loss


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _attn_spec(cfg: LMConfig, n_layers: int) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def w(*s):
        return Leaf((n_layers, *s), COMPUTE_DTYPE, "trunc", 0.02)
    return {
        "attn_norm": Leaf((n_layers, D), torch.float32, "ones"),
        "ffn_norm": Leaf((n_layers, D), torch.float32, "ones"),
        "wq": w(D, H * hd),
        "wk": w(D, KV * hd),
        "wv": w(D, KV * hd),
        "wo": w(H * hd, D),
    }


def _dense_layer_spec(cfg: LMConfig, n_layers: int, d_ff: int) -> dict:
    D = cfg.d_model

    def w(*s):
        return Leaf((n_layers, *s), COMPUTE_DTYPE, "trunc", 0.02)
    return {**_attn_spec(cfg, n_layers),
            "w_gate": w(D, d_ff), "w_up": w(D, d_ff), "w_down": w(d_ff, D)}


def _moe_layer_spec(cfg: LMConfig, n_layers: int) -> dict:
    """The router in f32; the routed experts' SwiGLU ``[L, E, ...]`` and
    the shared experts' (one SwiGLU of ``num_shared_experts`` x ``d_ff``
    columns) in bf16."""
    D, E, Fw = cfg.d_model, cfg.num_experts, cfg.d_ff

    def w(*s):
        return Leaf((n_layers, *s), COMPUTE_DTYPE, "trunc", 0.02)
    spec = {**_attn_spec(cfg, n_layers),
            "router": Leaf((n_layers, D, E), torch.float32, "trunc", 0.02),
            "we_gate": w(E, D, Fw), "we_up": w(E, D, Fw),
            "we_down": w(E, Fw, D)}
    if cfg.num_shared_experts:
        Fs = cfg.d_ff * cfg.num_shared_experts
        spec.update(ws_gate=w(D, Fs), ws_up=w(D, Fs), ws_down=w(Fs, D))
    return spec


def param_spec(cfg: LMConfig) -> dict:
    """Shapes, dtypes and initialisers of ``init_params``' tree."""
    spec = {
        "embed": Leaf((cfg.vocab_padded, cfg.d_model), COMPUTE_DTYPE,
                      "trunc", 0.02),
        "final_norm": Leaf((cfg.d_model,), torch.float32, "ones"),
        "lm_head": Leaf((cfg.d_model, cfg.vocab_padded), COMPUTE_DTYPE,
                        "trunc", 0.02),
    }
    if not cfg.moe:
        spec["layers"] = _dense_layer_spec(cfg, cfg.num_layers, cfg.d_ff)
        return spec
    if cfg.first_dense_layers:
        spec["dense_layers"] = _dense_layer_spec(cfg, cfg.first_dense_layers,
                                                 cfg.dense_ff)
    spec["layers"] = _moe_layer_spec(cfg, cfg.num_layers
                                     - cfg.first_dense_layers)
    return spec


def init_params(cfg: LMConfig, generator: torch.Generator | None = None, *,
                seed: int = 0, device="cuda") -> dict:
    """The reference's initialisation, drawn from ``generator`` (default: a
    generator on ``device`` seeded with ``seed``): weights 0.02 x a
    standard normal cut at +-2, in bf16 (the MoE router in f32); norms
    ones in f32. The draws are the port's own, not the reference's
    stream."""
    spec = param_spec(cfg)
    gen, dev = normal_generator(generator, seed, device)
    return draw_tree(spec, gen, dev)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms * w).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] (or [S]) absolute positions."""
    hd = x.shape[-1]
    half = hd // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=x.device), exps)
    ang = positions[..., None].float() * freqs                   # [B, S, half]
    cos = torch.cos(ang)[..., None, :]                           # [B, S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with JAX's promotion of mixed float dtypes."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _attn_core(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               positions: torch.Tensor, kv_positions: torch.Tensor,
               causal: bool, hd: int) -> torch.Tensor:
    """Dense attention over one query block. qg: [B, s, KV, G, hd]."""
    with family("attention"):
        scores = _einsum("bskgh,btkh->bkgst", qg, k).float() / math.sqrt(hd)
        if causal:
            mask = positions[:, :, None] >= kv_positions[:, None, :]
            scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
        attn = torch.softmax(scores, dim=-1).to(qg.dtype)
        return _einsum("bkgst,btkh->bskgh", attn, v)             # [B,s,KV,G,hd]


def gqa_attention(cfg: LMConfig, lp: dict, x: torch.Tensor,
                  positions: torch.Tensor, kv=None,
                  kv_positions: torch.Tensor | None = None,
                  causal: bool = True, return_kv: bool = False):
    """GQA attention. If ``kv`` is given it is the ``(k, v)`` caches with
    absolute ``kv_positions``; otherwise self-attention over ``x``.

    A sequence longer than ``Q_CHUNK`` (and a multiple of it) is attended
    in ``Q_CHUNK`` query blocks, one after another, so the ``[S, T]`` f32
    score matrix is never whole.
    """
    B, S, D = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KV

    q = (x @ lp["wq"]).reshape(B, S, H, hd)
    q = rope(q, positions, cfg.rope_theta)
    if kv is None:
        k = (x @ lp["wk"]).reshape(B, S, KV, hd)
        v = (x @ lp["wv"]).reshape(B, S, KV, hd)
        k = rope(k, positions, cfg.rope_theta)
        kv_positions = positions
    else:
        k, v = kv

    qg = q.reshape(B, S, KV, G, hd)
    if S <= Q_CHUNK or S % Q_CHUNK != 0:
        o = _attn_core(qg, k, v, positions, kv_positions, causal, hd)
    else:
        o = torch.cat([_attn_core(qg[:, i:i + Q_CHUNK], k, v,
                                  positions[:, i:i + Q_CHUNK], kv_positions,
                                  causal, hd)
                       for i in range(0, S, Q_CHUNK)], dim=1)

    out = o.reshape(B, S, H * hd) @ lp["wo"]
    if return_kv:
        return out, (k, v)
    return out


def swiglu(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def capacity(cfg: LMConfig, T: int) -> int:
    """Slots an expert takes from a block of ``T`` tokens: the reference's
    Python expression, whose float rounding decides C."""
    return max(int(T * cfg.top_k / cfg.num_experts * cfg.capacity_factor), 1)


def _moe_route(cfg: LMConfig, router: torch.Tensor, x: torch.Tensor, C: int,
               logits: torch.Tensor | None = None):
    """Routing and capacity ranking over a token block ``x [T, D]``:
    ``(flat_e, rank, keep, gates, aux)``.

    The router's logits in f32 (or ``logits``, given), softmax, the top-k
    choices with ties to the lowest expert (as ``lax.top_k``), their gates
    renormalised and cast to ``COMPUTE_DTYPE``; the Switch balance loss
    ``E * sum_e f_e * p_e`` with ``f_e`` from the first choice. Each
    assignment's rank within its expert comes from a stable sort of the
    flattened choices, so an expert past ``C`` drops the later tokens.
    """
    T = x.shape[0]
    E, K = cfg.num_experts, cfg.top_k
    if logits is None:
        logits = x.float() @ router                               # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, topk_idx = topk_lowest_index(probs, K)                 # [T, K]
    gates = (gates / gates.sum(-1, keepdim=True)).to(COMPUTE_DTYPE)

    me = probs.mean(0)
    fe = F.one_hot(topk_idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(fe * me)

    flat_e = topk_idx.reshape(T * K)
    sorted_e, sort_idx = torch.sort(flat_e, stable=True)
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=x.device),
                                side="left")
    rank_sorted = torch.arange(T * K, device=x.device) - starts[sorted_e]
    rank = torch.empty_like(flat_e).scatter_(0, sort_idx, rank_sorted)
    return flat_e, rank, rank < C, gates, aux


def _expert_compute(lp: dict, xe: torch.Tensor) -> torch.Tensor:
    h = F.silu(_einsum("ecd,edf->ecf", xe, lp["we_gate"])) * \
        _einsum("ecd,edf->ecf", xe, lp["we_up"])
    return _einsum("ecf,efd->ecd", h, lp["we_down"])              # [E?, C, D]


class _GatherRows(torch.autograd.Function):
    """``x[idx]`` (rows of ``x [N, D]``) whose backward is one f32
    ``index_add_`` of the output gradient, cast back to ``x``'s dtype: the
    reference's scatter-add. The default backward of advanced indexing
    sorts the indices and adds each index's duplicates one after another,
    and the dispatch's indices repeat thousands of times (every empty slot
    reads row 0, every dropped assignment the last slot)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        gx = torch.zeros(ctx.x_shape, dtype=torch.float32,
                         device=grad.device)
        return gx.index_add_(0, idx, grad.float()).to(ctx.x_dtype), None


def _moe_apply(cfg: LMConfig, lp: dict, x: torch.Tensor, flat_e, rank, keep,
               gates, E_loc: int, C: int, e_offset: int) -> torch.Tensor:
    """Gather-based dispatch, the experts ``[e_offset, e_offset + E_loc)``
    and the combine over one token block.

    The slot-to-token map is a 1-D int scatter; the ``[E_loc*C, D]``
    dispatch buffer is then a row gather, whose backward is one
    scatter-add (``_GatherRows``), and so is the read of each assignment's
    output. The combine sums each token's ``K`` outputs times their gates
    in ``x``'s dtype.
    """
    T, D = x.shape
    K = cfg.top_k
    local_e = flat_e - e_offset
    mine = keep & (local_e >= 0) & (local_e < E_loc)
    slot = torch.where(mine, local_e * C + rank, E_loc * C)
    assign_tok = torch.arange(T * K, device=x.device) // K
    # one spare slot takes every assignment that is not ours, then goes
    g = torch.full((E_loc * C + 1,), -1, dtype=torch.int64, device=x.device)
    g = g.scatter(0, slot, assign_tok)[:-1]
    ok = g >= 0
    buf = torch.where(ok[:, None], _GatherRows.apply(x, g.clamp(min=0)), 0)
    ye = _expert_compute(lp, buf.reshape(E_loc, C, D))
    y_slots = ye.reshape(E_loc * C, D)
    y_tok = torch.where(mine[:, None], _GatherRows.apply(
        y_slots, slot.clamp(0, E_loc * C - 1)), 0)
    return torch.sum(y_tok.reshape(T, K, D) * gates[..., None].to(x.dtype),
                     dim=1)


def _moe_ffn_dense(cfg: LMConfig, lp: dict, x: torch.Tensor):
    """One block of every token, every expert: the one-device path."""
    C = capacity(cfg, x.shape[0])
    flat_e, rank, keep, gates, aux = _moe_route(cfg, lp["router"], x, C)
    y = _moe_apply(cfg, lp, x, flat_e, rank, keep, gates, cfg.num_experts,
                   C, 0)
    return y, aux


def _expert_slice(cfg: LMConfig, lp: dict, j: int, m: int):
    """Model slice ``j`` of ``m``: ``(weights, E_loc, e_offset)``. Under
    ``moe_shard="expert"`` the experts ``[j E/m, (j+1) E/m)``; under
    ``"ffn"`` every expert's FFN columns ``[j F/m, (j+1) F/m)``."""
    E, Fw = cfg.num_experts, cfg.d_ff
    if cfg.moe_shard == "expert":
        E_loc = E // m
        sl = slice(j * E_loc, (j + 1) * E_loc)
        return ({n: lp[n][sl] for n in ("we_gate", "we_up", "we_down")},
                E_loc, j * E_loc)
    f = slice(j * Fw // m, (j + 1) * Fw // m)
    return ({"we_gate": lp["we_gate"][:, :, f], "we_up": lp["we_up"][:, :, f],
             "we_down": lp["we_down"][:, f]}, E, 0)


def _moe_ffn_sharded(cfg: LMConfig, lp: dict, x: torch.Tensor, mesh):
    """The reference's ``shard_map`` dispatch in one process, over
    ``mesh[data][model]`` (a grid of devices).

    The tokens split into ``data`` contiguous blocks, each routed and
    ranked with its own local capacity; each model slice (its experts, or
    its columns of every expert) runs on its grid device, and the slices'
    outputs are summed in slice order on ``x``'s device, standing for the
    ``psum`` over ``model``. ``aux`` is the mean over the data blocks.
    """
    dp, m = len(mesh), len(mesh[0])
    T = x.shape[0]
    T_loc = T // dp
    C = capacity(cfg, T_loc)
    ys, auxs = [], []
    for i in range(dp):
        x_loc = x[i * T_loc:(i + 1) * T_loc]
        route = _moe_route(cfg, lp["router"], x_loc, C)
        aux, y = route[-1], None
        for j in range(m):
            dev = mesh[i][j]
            w, E_loc, e0 = _expert_slice(cfg, lp, j, m)
            w = {n: t.to(dev) for n, t in w.items()}
            part = _moe_apply(cfg, w, x_loc.to(dev),
                              *(r.to(dev) for r in route[:4]), E_loc, C, e0)
            part = part.to(x.device)
            y = part if y is None else y + part
        ys.append(y)
        auxs.append(aux)
    return torch.cat(ys), torch.stack(auxs).mean()


def moe_ffn(cfg: LMConfig, lp: dict, x: torch.Tensor):
    """Capacity-based sort dispatch. ``x [T, D]`` tokens -> ``(y, aux)``.

    The sharded form when a mesh is in scope (``dist_ctx.use_mesh``), the
    token count divides its ``data`` axis and the expert count (``"expert"``)
    or ``d_ff`` (``"ffn"``) divides its ``model`` axis; else the one-block
    form. The shared experts' SwiGLU is added to either.
    """
    from . import dist_ctx
    mesh = dist_ctx.current_mesh()
    use_sharded = False
    if mesh is not None:
        dp, m = len(mesh), len(mesh[0])
        div_ok = (cfg.num_experts % m == 0 if cfg.moe_shard == "expert"
                  else cfg.d_ff % m == 0)
        use_sharded = (x.shape[0] % dp == 0 and x.shape[0] >= dp and div_ok)
    if use_sharded:
        y, aux = _moe_ffn_sharded(cfg, lp, x, mesh)
    else:
        y, aux = _moe_ffn_dense(cfg, lp, x)
    if cfg.num_shared_experts:
        y = y + swiglu(x, lp["ws_gate"], lp["ws_up"], lp["ws_down"])
    return y, aux


def moe_ffn_ref(cfg: LMConfig, lp: dict, x: torch.Tensor):
    """``moe_ffn``'s plain version, for the tests and the smoke: the same
    routing, then a loop over the experts, each taking the first ``C``
    tokens (in token order) that chose it, its SwiGLU on those rows, and
    the gated outputs added into an f32 sum. No slot map, no gather
    buffer, no batched product. Returns ``(y, aux, dropped)``, ``dropped``
    the number of assignments past capacity."""
    T = x.shape[0]
    E, K = cfg.num_experts, cfg.top_k
    C = capacity(cfg, T)
    probs = torch.softmax(x.float() @ lp["router"], dim=-1)
    gates, idx = topk_lowest_index(probs, K)
    gates = (gates / gates.sum(-1, keepdim=True)).to(COMPUTE_DTYPE)
    aux = E * torch.sum(F.one_hot(idx[:, 0], E).float().mean(0)
                        * probs.mean(0))
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dropped = 0
    for e in range(E):
        tok, k = (idx == e).nonzero(as_tuple=True)   # in token order
        dropped += max(len(tok) - C, 0)
        tok, k = tok[:C], k[:C]
        out = swiglu(x[tok], lp["we_gate"][e], lp["we_up"][e],
                     lp["we_down"][e])
        y.index_add_(0, tok, out.float() * gates[tok, k, None].float())
    y = y.to(x.dtype)
    if cfg.num_shared_experts:
        y = y + swiglu(x, lp["ws_gate"], lp["ws_up"], lp["ws_down"])
    return y, aux, dropped


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _layers(params: dict, stack: str = "layers") -> list[dict]:
    """Every layer's weights of one stack, one ``unbind`` a stacked weight
    (its backward stacks the layers' gradients once, where indexing layer
    by layer would add a full-size gradient per layer)."""
    if stack not in params:
        return []
    names = list(params[stack])
    cols = [params[stack][n].unbind(0) for n in names]
    return [dict(zip(names, ws)) for ws in zip(*cols)]


def _stacks(cfg: LMConfig, params: dict) -> list[tuple[dict, bool]]:
    """``(layer weights, moe)`` in order: a MoE config's leading dense
    layers, then its MoE layers (or a dense config's layers)."""
    return ([(lp, False) for lp in _layers(params, "dense_layers")]
            + [(lp, cfg.moe) for lp in _layers(params)])


def _block(cfg: LMConfig, lp: dict, x: torch.Tensor, positions: torch.Tensor,
           moe: bool, return_kv: bool = False):
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    att = gqa_attention(cfg, lp, h, positions, return_kv=return_kv)
    if return_kv:
        att, kv = att
    x = x + att
    h = rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)
    if moe:
        B, S, D = h.shape
        y, aux = moe_ffn(cfg, lp, h.reshape(B * S, D))
        out = x + y.reshape(B, S, D)
    else:
        out = x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_kv:
        return out, aux, kv
    return out, aux


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def forward_hidden(cfg: LMConfig, params: dict, tokens: torch.Tensor,
                   remat: bool = False):
    """tokens [B, S] -> (final hidden [B, S, D] (normed), aux_loss).

    ``remat=True`` checkpoints each layer, dense or MoE (recomputed in the
    backward): only the ``[B, S, D]`` hidden state between layers is kept
    for the backward, not the attention and FFN activations. ``aux_loss``
    is the MoE balance loss summed over the layers (an f32 zero for a
    dense config).
    """
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = _positions(B, S, tokens.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp, moe in _stacks(cfg, params):
        if remat:
            x, aux = checkpoint(_block, cfg, lp, x, positions, moe,
                                use_reentrant=False)
        else:
            x, aux = _block(cfg, lp, x, positions, moe)
        aux_total = aux_total + aux
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), aux_total


def forward(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            remat: bool = False):
    """tokens [B, S] -> (logits [B, S, V] f32, aux_loss)."""
    x, aux = forward_hidden(cfg, params, tokens, remat)
    logits = (x @ params["lm_head"]).float()
    return logits[..., :cfg.vocab_size], aux


def prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor):
    """Inference prefill: build the KV cache, return last-position logits.

    tokens [B, S] -> (logits [B, V] f32, cache {k, v: [L, B, S, KV, hd]}),
    the leading dense layers' KV before the MoE layers'.
    """
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = _positions(B, S, tokens.device)
    ks, vs = [], []
    for lp, moe in _stacks(cfg, params):
        x, _, (k, v) = _block(cfg, lp, x, positions, moe, return_kv=True)
        ks.append(k)
        vs.append(v)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, -1] @ params["lm_head"]).float()
    return logits[:, :cfg.vocab_size], {"k": torch.stack(ks),
                                        "v": torch.stack(vs)}


def _ce_chunk(cfg: LMConfig, lm_head: torch.Tensor, h: torch.Tensor,
              t: torch.Tensor) -> torch.Tensor:
    """Summed CE over one sequence chunk: the logsumexp over the vocabulary
    (padding rows masked to -1e30) minus the target's logit, taken as a
    column gather of ``lm_head`` (``[B, c, D]``, not ``[B, c, V]``)."""
    logits = (h @ lm_head).float()                               # [B, c, Vp]
    if cfg.vocab_padded != cfg.vocab_size:                       # mask padding
        pad = torch.arange(cfg.vocab_padded, device=h.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    w_t = lm_head.T[t.long()]                                    # [B, c, D]
    picked = torch.einsum("bsd,bsd->bs", h.float(), w_t.float())
    return torch.sum(lse - picked)


def lm_loss(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            remat: bool = True):
    """tokens [B, S+1]: causal LM loss (mean over tokens) + 0.01 x the MoE
    aux loss; returns ``(loss, {"loss", "aux"})``.

    The CE runs over ``CE_CHUNK``-token chunks, added in order, each under a
    checkpoint, so the ``[B, S, V]`` logits are never materialised (forward
    or backward); a sequence that is not a multiple of ``CE_CHUNK``, or not
    longer than it, takes one chunk, as in the reference.
    """
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    B, S = inputs.shape
    x, aux = forward_hidden(cfg, params, inputs, remat=remat)
    if S % CE_CHUNK != 0 or S <= CE_CHUNK:
        total = _ce_chunk(cfg, params["lm_head"], x, targets)
    else:
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, S, CE_CHUNK):
            total = total + checkpoint(
                _ce_chunk, cfg, params["lm_head"], x[:, i:i + CE_CHUNK],
                targets[:, i:i + CE_CHUNK], use_reentrant=False)
    loss = total / (B * S)
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


# ---------------------------------------------------------------------------
# decode path (KV cache)
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (cfg.num_layers, batch, max_len, KV, hd)
    return {"k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}


def decode_step(cfg: LMConfig, params: dict, cache: dict,
                token: torch.Tensor, pos: torch.Tensor):
    """One decode step. token [B], pos [B] current positions.

    cache k/v: [L, B, T, KV, hd] (a MoE config's leading dense layers
    first), written in place at each row's ``pos``. A MoE layer routes the
    step's ``B`` tokens as one block, its capacity taken from ``B``.
    Returns (logits [B, V], cache).
    """
    B = token.shape[0]
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    x = params["embed"][token.long()][:, None, :]                # [B, 1, D]
    pos = pos.long()
    positions = pos[:, None]                                     # [B, 1]
    Tmax = cache["k"].shape[2]
    kv_positions = _positions(B, Tmax, token.device)
    rows = torch.arange(B, device=token.device)
    for i, (lp, moe) in enumerate(_stacks(cfg, params)):
        ck, cv = cache["k"][i], cache["v"][i]
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        k_new = (h @ lp["wk"]).reshape(B, 1, KV, hd)
        v_new = (h @ lp["wv"]).reshape(B, 1, KV, hd)
        k_new = rope(k_new, positions, cfg.rope_theta)
        ck[rows, pos] = k_new[:, 0].to(ck.dtype)
        cv[rows, pos] = v_new[:, 0].to(cv.dtype)
        # positions past ``pos`` are masked out by the causal test
        x = x + gqa_attention(cfg, lp, h, positions, kv=(ck, cv),
                              kv_positions=kv_positions, causal=True)
        h = rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)
        if moe:
            y, _ = moe_ffn(cfg, lp, h.reshape(B, -1))
            x = x + y.reshape(B, 1, -1)
        else:
            x = x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ params["lm_head"]).float()
    return logits[:, :cfg.vocab_size], cache
