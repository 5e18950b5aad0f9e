"""Quickstart on the PyTorch port: build an assigned arch, run forward,
prefill into the paged pool and paged decode, and check that they agree.

  PYTHONPATH=src python examples/quickstart_torch.py [arch] [--device cpu]

After ``examples/quickstart.py``: a reduced config (d_model 64), random
fp32 weights from seed 0, tokens -> logits, then the serving path (prefill
fills the DPA paged KV pool; decode steps run ITPP attention against it)
and the continuous-batching engine. On the card (the default device) the
prefill and the forward run the prefill flash-attention kernel (K2) and
each decode step the paged split-K decode kernel (K1); ``--device cpu``
runs their plain versions. Exits 1 when the paths disagree.
"""
import argparse
import sys
from dataclasses import replace

import numpy as np
import torch

from repro_torch.configs import ASSIGNED, get_config, reduced
from repro_torch.core.allocator import PageAllocator
from repro_torch.core.paged_kv import PoolSpec
from repro_torch.kernels.backend import KernelConfig, resolve_device
from repro_torch.models import model as MDL

ap = argparse.ArgumentParser()
ap.add_argument("arch", nargs="?", default="llama3.2-1b", choices=ASSIGNED)
ap.add_argument("--device", default=None,
                help="cuda (the default) or cpu")
args = ap.parse_args()
dev = resolve_device(args.device)
cfg = replace(reduced(get_config(args.arch)), dtype="float32")
print(f"arch={cfg.name} family={cfg.family} layers={cfg.n_layers} "
      f"d_model={cfg.d_model} device={dev}")
rt = MDL.Runtime(kernels=KernelConfig())
params = MDL.init_params(cfg, seed=0, dtype=torch.float32, device=dev)
B, S, page, S_pre = 2, 12, 4, 8
gen = torch.Generator().manual_seed(1)
tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(dev)
frames = (0.1 * torch.randn(B, cfg.enc_seq, cfg.d_model, generator=gen)
          ).to(dev) if cfg.family == "encdec" else None
ok = True

with torch.inference_mode():
    # ---- 1. full-sequence forward ----
    logits, _ = MDL.forward(cfg, params, tokens, frames=frames, rt=rt)
    print("forward:", tuple(logits.shape),
          "finite:", bool(torch.isfinite(logits).all()))

    # ---- 2. serving path: prefill 8 tokens, decode 4 more ----
    n_attn = cfg.n_layers if cfg.family == "encdec" else sum(
        1 for k in cfg.block_kinds() if k in ("attn", "local"))
    spec = PoolSpec(max(n_attn, 1), 32, page, cfg.n_kv_heads, cfg.d_head,
                    S // page + 1, dtype="float32")
    state = MDL.init_decode_state(cfg, spec, B, device=dev)
    alloc = PageAllocator(32, 1, page)
    bts = []
    for b in range(B):
        alloc.admit(b, S)                   # lazy Va2Pa pages
        bts.append(alloc.block_table(b, spec.max_pages_per_req))
    bt = torch.as_tensor(np.stack(bts), dtype=torch.int32, device=dev)
    last, state = MDL.prefill(cfg, params, state, tokens[:, :S_pre], bt,
                              frames=frames, rt=rt)
    same = torch.allclose(last, logits[:, S_pre - 1], atol=1e-3)
    print("prefill logits match forward:", same)
    ok &= same
    for t in range(S_pre, S):
        ctx = torch.full((B,), t + 1, dtype=torch.int32, device=dev)
        npage = torch.as_tensor([bts[b][t // page] for b in range(B)],
                                dtype=torch.int32, device=dev)
        noff = torch.full((B,), t % page, dtype=torch.int32, device=dev)
        lg, state = MDL.decode_step(cfg, params, state, tokens[:, t], bt,
                                    ctx, npage, noff, rt=rt)
        same = torch.allclose(lg, logits[:, t], atol=5e-3)
        print(f"decode t={t}: argmax={int(lg[0].argmax())} "
              f"matches forward: {same}")
        ok &= same

# ---- 3. serving engine: continuous batching over the same model ----
if cfg.family != "encdec":
    from repro_torch.serving import DecodeEngine, EngineConfig, Request
    ecfg = EngineConfig(n_slots=2, page_size=page, n_pages=64,
                        max_context=32, eos_token=-1, prefill_mode="batched")
    eng = DecodeEngine(cfg, ecfg, params, device=dev)
    rng = np.random.default_rng(0)
    for r in range(3):
        eng.submit(Request(r, rng.integers(0, cfg.vocab_size, size=6), 4))
    outs = eng.run(100)
    done = eng.batcher.stats.completed
    print(f"serving: completed={done} prefill={eng.prefiller.name} "
          f"outputs={[list(v) for v in outs.values()]}")
    ok &= done == 3
print("done." if ok else "FAILED: the paths disagree")
sys.exit(0 if ok else 1)
