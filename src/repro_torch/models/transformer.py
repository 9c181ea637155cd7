"""Dense decoder-only LM: GQA, RoPE, RMSNorm, SwiGLU; serving and training.

The same model as the JAX reference's ``models/transformer.py`` for the
dense configs (codeqwen, yi, stablelm), with its stacked parameter layout:
every per-layer weight is one ``[L, ...]`` tensor under ``params["layers"]``,
so weights carry across as a tree map (``models.convert``). The forward
follows the dtype of the parameters as the reference's does: ``rmsnorm``
and ``rope`` compute in f32 and cast back, attention scores are taken in
f32 and the probabilities cast back, the logits are f32. Only
``init_cache`` fixes a dtype (``COMPUTE_DTYPE``).

Training: ``lm_loss`` is the reference's causal LM loss, its
cross-entropy over ``CE_CHUNK``-token chunks each under a checkpoint, so
the ``[B, S, V]`` logits are never whole; ``remat=True`` checkpoints each
layer (``torch.utils.checkpoint``, nothing saved inside a layer, as the
reference's ``jax.checkpoint(nothing_saveable)``).

Not ported here: the MoE layers (a config with ``moe=True`` raises
``NotImplementedError``) and the GSPMD sharding specs and ``act_spec``
(the port has no mesh of that kind).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import LMConfig
from ._params import Leaf, draw_tree, normal_generator

COMPUTE_DTYPE = torch.bfloat16
Q_CHUNK = 512   # query-block size for memory-bounded attention
CE_CHUNK = 256  # sequence chunk for the memory-bounded CE loss

MOE_NOT_PORTED = ("MoE layers are not ported yet (ROADMAP §1 item 14c, the "
                  "MoE layers); the port runs the dense configs")


def _check_dense(cfg: LMConfig) -> None:
    if cfg.moe:
        raise NotImplementedError(f"{cfg.name}: {MOE_NOT_PORTED}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _dense_layer_spec(cfg: LMConfig, n_layers: int, d_ff: int) -> dict:
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
        "w_gate": w(D, d_ff),
        "w_up": w(D, d_ff),
        "w_down": w(d_ff, D),
    }


def param_spec(cfg: LMConfig) -> dict:
    """Shapes, dtypes and initialisers of ``init_params``' tree."""
    _check_dense(cfg)
    return {
        "embed": Leaf((cfg.vocab_padded, cfg.d_model), COMPUTE_DTYPE,
                      "trunc", 0.02),
        "final_norm": Leaf((cfg.d_model,), torch.float32, "ones"),
        "lm_head": Leaf((cfg.d_model, cfg.vocab_padded), COMPUTE_DTYPE,
                        "trunc", 0.02),
        "layers": _dense_layer_spec(cfg, cfg.num_layers, cfg.d_ff),
    }


def init_params(cfg: LMConfig, generator: torch.Generator | None = None, *,
                seed: int = 0, device="cuda") -> dict:
    """The reference's initialisation, drawn from ``generator`` (default: a
    generator on ``device`` seeded with ``seed``): weights 0.02 x a
    standard normal cut at +-2, in bf16; norms ones in f32. The draws are the port's own, not the reference's stream."""
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
    scores = _einsum("bskgh,btkh->bkgst", qg, k).float() / math.sqrt(hd)
    if causal:
        mask = positions[:, :, None] >= kv_positions[:, None, :]  # [B, s, T]
        scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
    attn = torch.softmax(scores, dim=-1).to(qg.dtype)
    return _einsum("bkgst,btkh->bskgh", attn, v)                 # [B,s,KV,G,hd]


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
# forward passes
# ---------------------------------------------------------------------------

def _layers(params: dict) -> list[dict]:
    """Every layer's weights, one ``unbind`` a stacked weight (its backward
    stacks the layers' gradients once, where indexing layer by layer would
    add a full-size gradient per layer)."""
    names = list(params["layers"])
    cols = [params["layers"][n].unbind(0) for n in names]
    return [dict(zip(names, ws)) for ws in zip(*cols)]


def _block(cfg: LMConfig, lp: dict, x: torch.Tensor, positions: torch.Tensor,
           return_kv: bool = False):
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    att = gqa_attention(cfg, lp, h, positions, return_kv=return_kv)
    if return_kv:
        att, kv = att
    x = x + att
    h = rmsnorm(x, lp["ffn_norm"], cfg.norm_eps)
    out = x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
    if return_kv:
        return out, kv
    return out


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def forward_hidden(cfg: LMConfig, params: dict, tokens: torch.Tensor,
                   remat: bool = False):
    """tokens [B, S] -> (final hidden [B, S, D] (normed), aux_loss).

    ``remat=True`` checkpoints each layer (recomputed in the backward): only
    the ``[B, S, D]`` hidden state between layers is kept for the backward,
    not the attention and FFN activations. ``aux_loss`` is an f32 zero: it
    is the MoE balance loss in the reference, and the port runs dense
    configs only.
    """
    _check_dense(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = _positions(B, S, tokens.device)
    for lp in _layers(params):
        if remat:
            x = checkpoint(_block, cfg, lp, x, positions, use_reentrant=False)
        else:
            x = _block(cfg, lp, x, positions)
    return (rmsnorm(x, params["final_norm"], cfg.norm_eps),
            torch.zeros((), dtype=torch.float32, device=x.device))


def forward(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            remat: bool = False):
    """tokens [B, S] -> (logits [B, S, V] f32, aux_loss)."""
    x, aux = forward_hidden(cfg, params, tokens, remat)
    logits = (x @ params["lm_head"]).float()
    return logits[..., :cfg.vocab_size], aux


def prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor):
    """Inference prefill: build the KV cache, return last-position logits.

    tokens [B, S] -> (logits [B, V] f32, cache {k, v: [L, B, S, KV, hd]}).
    """
    _check_dense(cfg)
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    positions = _positions(B, S, tokens.device)
    ks, vs = [], []
    for lp in _layers(params):
        x, (k, v) = _block(cfg, lp, x, positions,
                           return_kv=True)
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
    _check_dense(cfg)
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (cfg.num_layers, batch, max_len, KV, hd)
    return {"k": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=COMPUTE_DTYPE, device=device)}


def decode_step(cfg: LMConfig, params: dict, cache: dict,
                token: torch.Tensor, pos: torch.Tensor):
    """One decode step. token [B], pos [B] current positions.

    cache k/v: [L, B, T, KV, hd], written in place at each row's ``pos``.
    Returns (logits [B, V], cache).
    """
    _check_dense(cfg)
    B = token.shape[0]
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    x = params["embed"][token.long()][:, None, :]                # [B, 1, D]
    pos = pos.long()
    positions = pos[:, None]                                     # [B, 1]
    Tmax = cache["k"].shape[2]
    kv_positions = _positions(B, Tmax, token.device)
    rows = torch.arange(B, device=token.device)
    for i, lp in enumerate(_layers(params)):
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
        x = x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ params["lm_head"]).float()
    return logits[:, :cfg.vocab_size], cache
