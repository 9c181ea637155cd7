"""Fault-tolerant training driver.

Trains any arch, ``lm`` (dense or MoE), ``gnn`` (NequIP) or ``recsys``
(the reduced smoke config unless ``--full-config``), with the whole
substrate: a seeded stateless data stream with background prefetch,
AdamW, optional gradient compression with error feedback, atomic keep-k
async checkpoints, resume from the newest, and an injected failure to
exercise the restart path. Runs on the GPU unless ``--device cpu``:

  python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --steps 200 --ckpt-dir /tmp/ckpt --batch 8 --seq 128

A ``gnn`` arch trains on ``gnn_batch`` graphs of ``--gnn-nodes`` nodes and
``--gnn-edges`` edges in ``--gnn-graphs`` graphs.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from functools import partial

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..core.common import resolve_device
from ..data import gnn_batch, lm_token_batch, recsys_batch
from ..data.pipeline import PrefetchPipeline, SyntheticStream
from ..models import (get_api, nequip, recsys as recsys_mod, transformer,
                      value_and_grad)
from .._tree import tree_leaves
from ..train import (CheckpointManager, CompressorConfig, adamw_init,
                     adamw_update, compress_init, compressed_grads)


def make_loss(api, cfg, args):
    if api.family == "lm":
        def loss(p, b):
            return transformer.lm_loss(cfg, p, b["tokens"])
        return loss
    if api.family == "gnn":
        def loss(p, b):
            return nequip.loss_fn(cfg, p, {**b, "n_graphs": args.gnn_graphs})
        return loss
    return partial(recsys_mod.loss_fn, cfg)


def make_batch_fn(api, cfg, args):
    if api.family == "lm":
        return lambda step: {"tokens": lm_token_batch(
            cfg.vocab_size, args.batch, args.seq, seed=step)}
    if api.family == "gnn":
        def fn(step):
            b = gnn_batch(cfg, args.gnn_nodes, args.gnn_edges, seed=step,
                          n_graphs=args.gnn_graphs)
            b.pop("n_graphs")
            return b
        return fn
    return lambda step: recsys_batch(cfg, args.batch, seed=step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--full-config", action="store_true",
                    help="use the production config (needs real hardware)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (default cuda; cpu runs "
                         "the kernels' plain versions)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--gnn-nodes", type=int, default=64)
    ap.add_argument("--gnn-edges", type=int, default=256)
    ap.add_argument("--gnn-graphs", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", choices=("none", "topk", "int8"),
                    default="none")
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="inject a crash (fault-tolerance demo)")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full_config else get_smoke_config(args.arch)
    api = get_api(cfg)
    print(f"arch={cfg.name} family={api.family} device={dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
             else ""))

    gen = torch.Generator(device=dev).manual_seed(0)
    params = api.init_params(gen, device=dev)
    opt_state = adamw_init(params)
    n_params = sum(p.numel() for _, p in tree_leaves(params))
    print(f"params: {n_params:,}")

    comp_cfg = CompressorConfig(scheme=args.compress)
    ef = compress_init(params)
    loss_fn = make_loss(api, cfg, args)

    def train_step(params, opt_state, ef, batch):
        (_, metrics), grads = value_and_grad(loss_fn, params, batch)
        grads, ef = compressed_grads(comp_cfg, grads, ef)
        params, opt_state, om = adamw_update(api.opt_cfg, grads, opt_state,
                                             params)
        return params, opt_state, ef, {**metrics, **om}

    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    start_step = 0
    if args.resume and mgr.latest_step() is not None:
        state = {"params": params, "opt": opt_state, "ef": ef}
        state, meta = mgr.restore(state)
        params, opt_state, ef = state["params"], state["opt"], state["ef"]
        start_step = meta["step"] + 1
        print(f"resumed from step {meta['step']}")

    make_batch = make_batch_fn(api, cfg, args)
    stream = SyntheticStream(make_batch, start_step)
    pipe = PrefetchPipeline(iter(stream), depth=2)

    t0 = time.time()
    losses = []
    for step in range(start_step, args.steps):
        if step == args.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in next(pipe).items()}
        params, opt_state, ef, metrics = train_step(params, opt_state, ef,
                                                    batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({dt / max(step - start_step + 1, 1):.2f}s/step)",
                  flush=True)
        if step > 0 and step % args.ckpt_every == 0:
            mgr.save(step, {"params": params, "opt": opt_state, "ef": ef})
    mgr.save(args.steps - 1, {"params": params, "opt": opt_state, "ef": ef})
    mgr.wait()
    print(f"first-10 mean loss {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean loss {np.mean(losses[-10:]):.4f}")


if __name__ == "__main__":
    main()
