"""RecSys towers: wide-deep, AutoInt, DIEN (AUGRU), SASRec.

The same models as the JAX reference's ``models/recsys.py``, with its
parameter tree, and its training loss (``loss_fn``). Sparse lookups are
gathers; wide-deep's multi-hot behaviour bag goes through the port's
``embed_bag`` (the hand-written CUDA kernel on a CUDA tensor, its plain
version on a CPU tensor), where the reference sums a jnp gather. The bag
is differentiable in its table on both devices (on the card through
``EmbedBagFunction``: the kernel forward, a plain scatter-add backward), so
``loss_fn`` trains every table.

Every tower also exposes a retrieval tower: ``user_repr`` scored against
the item catalogue with a top-k whose ties go to the lowest item id, as
``lax.top_k``'s do (the ``retrieval_cand`` shape; the catalogue can also be
served from the updatable HNSW index, ``repro_torch.api``).

Not ported here: the GSPMD sharding specs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import RecSysConfig
from ..kernels.embed_bag import embed_bag
from ._params import Leaf, draw_tree, normal_generator
from ._scope import family

_F32 = torch.float32


def _lin_spec(n_in: int, n_out: int) -> dict:
    return {"w": Leaf((n_in, n_out), _F32, "normal", 1 / math.sqrt(n_in)),
            "b": Leaf((n_out,), _F32, "zeros")}


def _mlp_spec(dims) -> list:
    return [_lin_spec(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]


def _apply(lin: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ lin["w"] + lin["b"]


def _mlp(layers: list, x: torch.Tensor, final_act: bool = False):
    for i, lin in enumerate(layers):
        x = _apply(lin, x)
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def param_spec(cfg: RecSysConfig) -> dict:
    """Shapes, dtypes and initialisers of ``init_params``' tree (all f32;
    embedding tables N(0, 0.05^2), projections N(0, 1 / fan_in))."""
    D, scale = cfg.embed_dim, 0.05

    def table(*s):
        return Leaf(s, _F32, "normal", scale)

    def proj(n_in, n_out):
        return Leaf((n_in, n_out), _F32, "normal", 1 / math.sqrt(n_in))

    p: dict = {"item_embed": table(cfg.items_padded, D)}
    if cfg.kind == "wide_deep":
        p["tables"] = table(cfg.n_sparse, cfg.vocab_size, D)
        p["wide"] = table(cfg.vocab_size)
        p["bag_table"] = table(cfg.vocab_size, D)
        p["mlp"] = _mlp_spec(((cfg.n_sparse + 1) * D, *cfg.mlp, 1))
        p["user_proj"] = _lin_spec(cfg.mlp[-1], D)
    elif cfg.kind == "autoint":
        p["tables"] = table(cfg.n_sparse, cfg.vocab_size, D)
        layers, d_in = [], D
        for _ in range(cfg.n_attn_layers):
            width = cfg.n_heads * cfg.d_attn
            layers.append({name: proj(d_in, width)
                           for name in ("wq", "wk", "wv", "wres")})
            d_in = width
        p["attn_layers"] = layers
        p["logit"] = _lin_spec(cfg.n_sparse * d_in, 1)
        p["user_proj"] = _lin_spec(cfg.n_sparse * d_in, D)
    elif cfg.kind == "dien":
        G = cfg.gru_dim
        p["gru"] = {k: proj(D + G, G) for k in ("wz", "wr", "wh")}
        p["augru"] = {k: proj(D + G, G) for k in ("wz", "wr", "wh")}
        p["attn"] = _lin_spec(G + D, 1)
        p["mlp"] = _mlp_spec((G + D, *cfg.mlp, 1))
        p["user_proj"] = _lin_spec(G, D)
    elif cfg.kind == "sasrec":
        p["pos_embed"] = table(cfg.seq_len, D)
        p["blocks"] = [{"wq": proj(D, D), "wk": proj(D, D), "wv": proj(D, D),
                        "ff": _mlp_spec((D, D, D)),
                        "ln1": Leaf((D,), _F32, "ones"),
                        "ln2": Leaf((D,), _F32, "ones")}
                       for _ in range(cfg.n_blocks)]
    else:
        raise ValueError(cfg.kind)
    return p


def init_params(cfg: RecSysConfig, generator: torch.Generator | None = None,
                *, seed: int = 0, device="cuda") -> dict:
    """The reference's initialisation (shapes, dtypes, scales), drawn from
    ``generator`` (default: a generator on ``device`` seeded with
    ``seed``). The draws are the port's own, not the reference's stream."""
    spec = param_spec(cfg)
    gen, dev = normal_generator(generator, seed, device)
    return draw_tree(spec, gen, dev)


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays (``data.recsys_batch``) as tensors on
    ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# forward per kind
# ---------------------------------------------------------------------------

def _field_lookup(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """tables [F, V, D], ids [B, F] -> [B, F, D]."""
    F_ = tables.shape[0]
    return tables[torch.arange(F_, device=ids.device)[None, :], ids.long()]


def _wide_deep_forward(cfg, p, batch, bag=embed_bag):
    emb = _field_lookup(p["tables"], batch["sparse_ids"])        # [B, F, D]
    pooled = bag(p["bag_table"], batch["bag_ids"], "sum")        # [B, D]
    x = torch.cat([emb.reshape(emb.shape[0], -1), pooled], dim=-1)
    hidden = x
    for lin in p["mlp"][:-1]:
        hidden = torch.relu(_apply(lin, hidden))
    deep_logit = _apply(p["mlp"][-1], hidden)[:, 0]
    wide_logit = torch.sum(p["wide"][batch["sparse_ids"].long()], dim=-1)
    user = _apply(p["user_proj"], hidden)
    return deep_logit + wide_logit, user


def _autoint_forward(cfg, p, batch):
    x = _field_lookup(p["tables"], batch["sparse_ids"])          # [B, F, D]
    H, da = cfg.n_heads, cfg.d_attn
    for lyr in p["attn_layers"]:
        B, F_, _ = x.shape
        q = (x @ lyr["wq"]).reshape(B, F_, H, da)
        k = (x @ lyr["wk"]).reshape(B, F_, H, da)
        v = (x @ lyr["wv"]).reshape(B, F_, H, da)
        with family("attention"):
            s = torch.einsum("bfhd,bghd->bhfg", q, k) / math.sqrt(da)
            a = torch.softmax(s, dim=-1)
            o = torch.einsum("bhfg,bghd->bfhd", a, v).reshape(B, F_, H * da)
        x = torch.relu(o + x @ lyr["wres"])
    flat = x.reshape(x.shape[0], -1)
    user = _apply(p["user_proj"], flat)
    return _apply(p["logit"], flat)[:, 0], user


def _gru_scan(w, xs, mask, h0, alphas=None):
    """(AU)GRU over time, one step at a time. xs [B,T,D], mask [B,T]; alphas
    [B,T] for AUGRU (scales the update gate). A step whose mask is 0 keeps
    ``h``. Returns (h_T, states [B,T,G])."""
    h, hs = h0, []
    for t in range(xs.shape[1]):
        x = xs[:, t]
        xh = torch.cat([x, h], dim=-1)
        z = torch.sigmoid(xh @ w["wz"])
        r = torch.sigmoid(xh @ w["wr"])
        hh = torch.tanh(torch.cat([x, r * h], dim=-1) @ w["wh"])
        if alphas is not None:
            z = z * alphas[:, t, None]             # attention-updated gate
        hn = (1 - z) * h + z * hh
        h = torch.where(mask[:, t, None] > 0, hn, h)
        hs.append(h)
    return h, torch.stack(hs, dim=1)


def _dien_forward(cfg, p, batch):
    hist_ids = batch["hist_ids"].long()
    hist = p["item_embed"][hist_ids.clamp_min(0)]                # [B, T, D]
    mask = (hist_ids >= 0).float()
    tgt = p["item_embed"][batch["target_id"].long()]             # [B, D]
    h0 = torch.zeros((hist.shape[0], cfg.gru_dim), dtype=_F32,
                     device=hist.device)
    _, states = _gru_scan(p["gru"], hist, mask, h0)              # [B, T, G]
    att_in = torch.cat([states, tgt[:, None].expand(*states.shape[:2], -1)],
                       dim=-1)
    scores = _apply(p["attn"], att_in)[..., 0]                   # [B, T]
    scores = scores.masked_fill(mask <= 0, -1e30)
    alphas = torch.softmax(scores, dim=-1)
    hT, _ = _gru_scan(p["augru"], hist, mask, h0, alphas=alphas)
    feat = torch.cat([hT, tgt], dim=-1)
    user = _apply(p["user_proj"], hT)
    return _mlp(p["mlp"], feat)[:, 0], user


def _sasrec_encode(cfg, p, seq_ids):
    D = cfg.embed_dim
    seq_ids = seq_ids.long()
    mask = seq_ids >= 0
    x = p["item_embed"][seq_ids.clamp_min(0)] + p["pos_embed"]
    x = x * mask[..., None]
    T = seq_ids.shape[1]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                   device=x.device))
    keep = causal[None] & mask[:, None, :]
    for blk in p["blocks"]:
        # no bias; eps inside the square root, as the reference's norm
        h = F.layer_norm(x, (D,), blk["ln1"], None, 1e-6)
        q, k, v = h @ blk["wq"], h @ blk["wk"], h @ blk["wv"]
        with family("attention"):
            s = torch.einsum("btd,bsd->bts", q, k) / math.sqrt(D)
            s = s.masked_fill(~keep, -1e30)
            x = x + torch.einsum("bts,bsd->btd", torch.softmax(s, -1), v)
        h = F.layer_norm(x, (D,), blk["ln2"], None, 1e-6)
        x = x + _mlp(blk["ff"], h)
    return x * mask[..., None]                                   # [B, T, D]


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def forward(cfg: RecSysConfig, params: dict, batch: dict, *, bag=embed_bag):
    """Ranking logit [B] and the user representation [B, D].

    ``bag(table, ids, "sum")`` computes wide-deep's behaviour bag: the
    ``embed_bag`` wrapper (the kernel on a CUDA tensor), or
    ``embed_bag_ref`` to hold the kernel against its plain version.
    """
    if cfg.kind == "wide_deep":
        return _wide_deep_forward(cfg, params, batch, bag)
    if cfg.kind == "autoint":
        return _autoint_forward(cfg, params, batch)
    if cfg.kind == "dien":
        return _dien_forward(cfg, params, batch)
    if cfg.kind == "sasrec":
        user = _sasrec_encode(cfg, params, batch["seq_ids"])[:, -1]
        tgt = params["item_embed"][batch["target_id"].long()]
        return torch.sum(user * tgt, dim=-1), user
    raise ValueError(cfg.kind)


def loss_fn(cfg: RecSysConfig, params: dict, batch: dict, *, bag=embed_bag):
    """The training loss and its metrics, ``(loss, {"loss": loss})``.

    SASRec: the masked log-sigmoid of the encoder's states against the
    positive and the negative next items (``pos_ids`` >= 0 counted);
    wide-deep, AutoInt, DIEN: the logistic loss of the ranking logit on
    ``label``, mean over the batch. ``bag`` as in ``forward``.
    """
    if cfg.kind == "sasrec":
        enc = _sasrec_encode(cfg, params, batch["seq_ids"])      # [B, T, D]
        pos_ids, neg_ids = batch["pos_ids"].long(), batch["neg_ids"].long()
        pos = params["item_embed"][pos_ids.clamp_min(0)]
        neg = params["item_embed"][neg_ids.clamp_min(0)]
        lp = torch.sum(enc * pos, dim=-1)
        ln_ = torch.sum(enc * neg, dim=-1)
        m = (pos_ids >= 0).float()
        loss = -torch.sum((F.logsigmoid(lp) + F.logsigmoid(-ln_)) * m) \
            / torch.clamp_min(m.sum(), 1)
        return loss, {"loss": loss}
    logit, _ = forward(cfg, params, batch, bag=bag)
    y = batch["label"].float()
    loss = torch.mean(torch.clamp_min(logit, 0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))
    return loss, {"loss": loss}


def user_repr(cfg: RecSysConfig, params: dict, batch: dict) -> torch.Tensor:
    if cfg.kind == "sasrec":
        return _sasrec_encode(cfg, params, batch["seq_ids"])[:, -1]
    return forward(cfg, params, batch)[1]


def topk_lowest_index(scores: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the k largest values, in
    descending order, ties to the lowest index.

    ``torch.topk`` does not promise the order of ties, so the top-k runs on
    one int64 key per entry: the score's bits mapped to an order-preserving
    integer in the high word, the complement of the index in the low word.
    """
    if scores.dtype != _F32:
        raise TypeError(f"topk_lowest_index takes float32, got {scores.dtype}")
    N = scores.shape[-1]
    if N >= 2 ** 32:
        raise ValueError("topk_lowest_index takes fewer than 2^32 entries")
    bits = scores.contiguous().view(torch.int32)
    # negative floats order backwards: flip their magnitude bits
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    idx = torch.arange(N, dtype=torch.int64, device=scores.device)
    key = (ordered.long() << 32) | ((2 ** 32 - 1) - idx)
    top = torch.topk(key, k, dim=-1).values                      # sorted desc
    ids = (2 ** 32 - 1) - (top & (2 ** 32 - 1))
    return torch.gather(scores, -1, ids), ids


def retrieval_scores(cfg: RecSysConfig, params: dict, batch: dict,
                     k: int = 100):
    """Score the user representations against the whole item catalogue
    (``u @ item_embed.T``), padding rows masked to ``-inf``, and return the
    top-k ``(scores [B, k], item ids [B, k])``, ties to the lowest id.

    This is the brute-force path of the ``retrieval_cand`` shape; the
    serving stack can answer from the HNSW index instead.
    """
    u = user_repr(cfg, params, batch)                            # [B, D]
    scores = u @ params["item_embed"].T                          # [B, items_padded]
    if cfg.items_padded != cfg.n_items:
        scores[:, cfg.n_items:] = -math.inf
    return topk_lowest_index(scores, k)
