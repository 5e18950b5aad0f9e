"""End-to-end training driver: config -> train loop with checkpoint /
restart, on one device.

Port of ``repro/launch/train.py``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 300 --d-model 512 --layers 8 --seq 512 --batch 8

Runs on the card unless ``--device cpu`` asks for the CPU (without a card
and without ``--device cpu`` it raises). The step is
``training.train.make_train_step`` on ``models.model.DEFAULT_RT``: the
plain paths, no kernel (none of the port's kernels has a backward). Fault
tolerance as repro's: the loop checkpoints every ``--ckpt-every`` steps
(manifest-gated), restores the newest complete step on restart onto the
training device, and ``data.pipeline.TrainPipeline`` is seeded per step, so
the token stream replays identically. Prints repro's ``[train] step ...``
lines; ``main`` returns the last step's loss.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import TrainPipeline
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import model as MDL
from repro_torch.runtime import checkpoint as CK
from repro_torch.training import optimizer as OPT
from repro_torch.training.train import make_train_step, to_device


def shrink(cfg, args):
    """Optionally shrink the arch for small runs (~100M params)."""
    kw = {}
    if args.d_model:
        kw.update(d_model=args.d_model,
                  n_heads=max(4, args.d_model // 128),
                  n_kv_heads=max(2, min(cfg.n_kv_heads,
                                        args.d_model // 256)),
                  d_head=min(cfg.d_head, 64) if cfg.d_head else cfg.d_head)
        if cfg.d_ff:
            kw["d_ff"] = args.d_model * 4
    if args.layers:
        n = args.layers
        if len(cfg.pattern) > 1:
            n = max(len(cfg.pattern), n - n % len(cfg.pattern))
        kw["n_layers"] = n
    if args.vocab:
        kw["vocab_size"] = args.vocab
    return replace(cfg, **kw, dtype="float32")


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None, *, params=None):
    """Train; returns the last step's loss (None when a restart finds
    every step done). ``params``: starting weights in the port's layout on
    the training device (default: ``init_params`` from seed 0)."""
    args = parse(argv)
    dev = resolve_device(args.device)
    cfg = shrink(get_config(args.arch), args)
    if params is None:
        params = MDL.init_params(cfg, 0, torch.float32, dev)
    print(f"[train] arch={cfg.name} "
          f"params={MDL.param_count_actual(params) / 1e6:.1f}M "
          f"seq={args.seq} batch={args.batch} device={dev}", flush=True)

    opt_cfg = OPT.AdamWConfig(lr=args.lr,
                              warmup_steps=min(50, args.steps // 10 + 1),
                              total_steps=args.steps)
    step_fn = make_train_step(cfg, MDL.DEFAULT_RT, opt_cfg)
    opt = OPT.init(params)
    pipe = TrainPipeline(cfg.vocab_size, args.seq, args.batch)

    start = 0
    if args.ckpt_dir:
        latest = CK.latest_step(args.ckpt_dir)
        if latest is not None:
            state = CK.restore(args.ckpt_dir, latest,
                               {"params": params, "opt": opt})
            params, opt = state["params"], state["opt"]
            start = latest + 1
            print(f"[train] restored step {latest}", flush=True)

    t0, tok, loss = time.time(), 0, None
    for step in range(start, args.steps):
        batch = to_device(pipe.batch(step), dev)
        params, opt, metrics = step_fn(params, opt, batch)
        tok += args.batch * args.seq
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            print(f"[train] step {step:5d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"tok/s={tok / max(dt, 1e-9):,.0f}", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            CK.save(args.ckpt_dir, step, {"params": params, "opt": opt})
    return loss


if __name__ == "__main__":
    main()
