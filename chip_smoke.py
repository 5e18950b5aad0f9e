#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. device  — a CUDA card of compute capability 9.0; prints its name and
   power limit (``nvidia-smi``).
2. build   — compiles ``src/repro_torch/csrc/*.cu`` with nvcc for sm_90a
   (one nvcc per source, in parallel) and prints ptxas' registers, shared
   memory and spills per kernel, and, from ``cuobjdump -sass`` of the
   built K2 and K4 libraries, their tensor-core instructions per
   instantiation (K2: ``HGMMA`` for bf16, ``HMMA`` for fp32; K4's chunk
   kernel: ``HMMA``; fails if one has none; K4's step kernel has none).
3. kernels — every CUDA kernel against its plain PyTorch version at the
   shapes the serving paths give it (llama3.2-1b and zamba2-1.2b), in fp32
   and with bf16 inputs, with the kernel's time, its bound, the plain
   version's time and a library call's time where one exists (CUDA events
   after warm-up; K1, K3 and K4 also by CUDA-graph replay, which leaves
   out the host's dispatch, printed beside). Bounds take each row's input type:
   bf16 bytes at 2 a value and 989 TF/s; fp32 bytes at 4 and, for K1 and
   K2, 495/3 TF/s, the 3xTF32 rate (67 TF/s, the CUDA cores' rate,
   printed beside it), for K3 67 TF/s; K4 takes its route's rates: 495/3 TF/s for fp32
   inputs; for bf16, q k^T at 989 TF/s (bf16 mma) and its three other
   products at 495/2 (two TF32 products each); the 67 TF/s figure beside
   it. Tolerances: attention fp32 2e-5 and bf16
   2e-2 absolute (reduction order; bf16 rounding of the probabilities);
   the Mamba2 scan 2e-5 of the output's largest magnitude for both input
   types (its products are split TF32 products good to ~2^-21, bf16
   inputs are exact in TF32, and otherwise only the reduction order
   differs; the sums reach magnitudes of ~100).
   K3 (ITPP split-K flash decode) at the kernel bench's shape, at a tail
   split with dead splits and a ctx = 0 row, at llama3.2-1b's decode
   geometry over 32768 tokens and at whisper-small's cross-attention decode
   (B 8, 12 heads, 1500 encoder rows, 8 splits, the tail split padded: its
   serving shape, the ``kernels`` line's), with
   ``F.scaled_dot_product_attention`` as
   its library yardstick (it gives the MERGED output, not the partials);
   K1 also at 256-token pages with D 128, at the bench's decode-step
   shape (ctx 262144, ``n_splits`` 1 and 64) and in its speculative verify
   mode at llama3.2-1b's geometry: qpos 5, 16 and 33 (20, 64 and 132 q
   rows; more than 32 rows launch once a row tile), no library call
   computing paged verify attention. K4 at zamba2's prefill (B8
   S1024, chunk 128), decode (B8 S1, chunk 1), slot prefill (B1 S1024) and
   chunked prefill (B8 S128) shapes, the two prefill shapes also at the
   other width of a block's slice of P (32 or 64 columns), and at a prime
   slot prompt (B1 S1031: chunk 1 as the scan ran it unpadded, and S1056
   chunk 96 with the tail as identity steps, as ``models/ssm.py`` pads it;
   ROADMAP C.6) beside S1024. K1 and K2 also at the model zoo's head
   layouts at D 128 (phase 9's paths): qwen1.5-7b (32 kv heads, G 1),
   gemma3-27b (16 / 2, its local layers' 1024-token window), phi3.5-moe
   (8 / 4) and yi-34b (8 / 7); K1 at 8 slots of up to 2048 tokens, also
   qwen's verify pass at qpos 5; K2 at Sq = Skv = 1024, gemma3 also as a
   chunk at offsets 1024 / 512 against 2048 keys. K2 without the causal
   mask at whisper-small's encoder (B 8, Sq = Skv = 1500, ragged against
   its 64-token tiles) and cross prefill (Sq 416 against 1500 keys), with
   SDPA without a mask as the library call. K1 also on the shard-local
   tables phase 15 gives it (``SHARD_PAGED``): one shard's view of a
   page-sharded pool with every other shard's entries -1, at long_500k's
   global layer, its 6-slot ``windowed_slice``, and llama3.2-1b's batched
   and pipeline rows; their bounds count the tokens the tables hold. K2
   also at phase 15 (b)'s sharded prefill: a shard's 4 rows of 256
   queries at q_offset 0 / 256 / 512 / 768 against 1024 gathered keys,
   at phase 17's ``ProcessMesh`` prefill, and at the pipeline's unsharded
   prefill (phase 15 (d), phase 17 (c): 4 rows of 256 tokens).
   At per-row offsets (the chunk, the sharded prefill, gemma3's chunk)
   the library call is SDPA with a boolean ``[B, 1, Sq, Skv]`` mask built
   from ``q_offset`` (and the window), itself held to the plain version.
4. bench   — ``python -m repro_torch.launch.kernel_bench`` at full size,
   in-process: its asserts must hold and each kernel's launch count must
   equal the calls the bench made of its wrapper (K3 launches here and on
   whisper's decode path, phase 13).
5. engine  — llama3.2-1b and zamba2-1.2b at full width and depth (random
   fp32 weights from a seed, fp32 paged pool) served through
   ``repro_torch.serving.DecodeEngine`` in batched and chunked prefill,
   three ways: the decode horizon as CUDA graphs (the default), dispatched
   eagerly (``decode_graphs=False``) and on the plain paths
   (``use_kernels=False``). Greedy tokens must be identical (a first
   divergence whose plain-path logit gap is below 1e-5 is a near tie,
   ROADMAP C.3: printed, not a fault), device syncs equal, every request
   complete, every page released, and, for graphs and eager, each
   kernel's launch count equal to what the run's decode steps and prefill
   calls imply (K4 by route: its chunk kernel 36 x prefill calls, its step
   kernel 36 x decode steps). Each way prints decode tok/s, decode step
   ms, TTFT, syncs per token and its graph captures and capture time.
6. profile — each model's batched configuration on the graph path under
   ``torch.profiler``: device busy time against wall time (also without
   the captures' time), and the kernels that take it, once K1's calls
   show that the kernels inside the graphs are attributed.
7. kvcache — the KV-cache hierarchy at full width and depth on the graph
   path (fp32 pool, page 16, 8 slots). llama3.2-1b serves 16 requests of
   512-1024 tokens whose prompts share 90% with a system prompt (as
   ``launch/serve.py --shared-frac 0.9`` builds them), 32 new tokens each:
   (a) without the prefix cache on an ample pool (the reference), (b)
   with it in batched and chunked prefill, (c) with it on a pool of ~40%
   of (a)'s peak pages and a host tier for the rest (no same-tick dedup),
   so watermark offload and swap-in both run. Tokens must equal (a)'s
   (the near-tie rule of phase 5), (b) and (c) must hit and copy on write,
   (c) must swap both ways, every page must end free or held by the
   tree, the pool must keep its tensors, and launches must equal what the
   decode steps and prefill calls (suffix calls included) imply. Prints
   TTFT of hit against cold requests, peak pages with and without the
   cache, swap pages, bytes, device ms and GB/s. zamba2-1.2b serves 8
   requests in batched and chunked prefill on an ample pool and on a
   120-page pool that preempts, with preemption snapshots
   (``state_resume``) and without: tokens equal the ample pool's,
   restores only with snapshots, none left behind.
8. spec    — speculative decoding and stochastic sampling at full width
   on the graph path (fp32 pool, page 16, 8 slots, batched prefill, 8
   prompts of 256-1024 tokens, 32 new tokens). llama3.2-1b: (a) the
   zeroed-layer oracle target (``models.convert.oracle_draft_pair``: wo
   and w2 zero in layers 2..16) alone at horizon spec_horizon + 1, the
   reference; (b) the oracle pair (the target's 1-layer slice as the
   draft) at spec_horizon 4 and 15, the round as one CUDA graph per
   (width, K) and eagerly: tokens equal (a)'s (the near-tie rule of phase
   5), counters equal between the two, acceptance above zero; prints the
   mean accept length, decode tok/s against (a), syncs per token, the
   graph captures and the draft's share of a round's device time (the
   captured round and the draft's scan alone, replayed); (c) an
   independent 1-layer draft (seed 7), which rolls back nearly every
   round, against the unmodified target alone; (d) temperature 0.8 and
   top-k 8 with the oracle pair, and zamba2-1.2b with top-k 8 and no draft
   (the K4 paths), each twice with one seed: identical tokens. Every run
   completes and releases every page, and launches equal what its rounds
   imply (K1: the draft's K - 1 steps x its layer, the verify pass x 16
   layers x its row tiles; K2: prefill calls x 16 and catch-up calls x 1).
9. models  — the model zoo at full width on the graph path and the plain
   path (random fp32 weights from seed 0, fp32 pool, page 16, 8 slots, 8
   requests of 32 new tokens, batched prefill, horizon 4): qwen1.5-7b with
   all 32 layers, gemma3-27b's first 6 of 62 layers (one 5:1 local:global
   cycle; prompts of 1100-2048 tokens, so the local windows cut) and
   phi3.5-moe-42b-a6.6b's first 4 of 32 layers (16 experts, top 2, capacity
   factor 1.25; its dropped choices are counted on an eager plain run).
   Tokens equal (the near-tie rule of phase 5; for the MoE a divergence
   also prints where the routing first differs and the router's gap there),
   launches equal what the decode steps and prefill calls imply, every page
   released. Prints decode tok/s, TTFT, the replayed decode step and peak
   device memory, and profiles each graph run as phase 6 does.

10. lifecycle — the request lifecycle and telemetry on the graph path,
   llama3.2-1b at full width (fp32, page 16, 8 slots, batched prefill,
   horizon 4, 8 prompts of 256-1024 tokens, 32 new tokens): (a) telemetry
   off against on (metrics, Perfetto trace and request log under
   ``build/lifecycle/``): tokens, device syncs and launches identical,
   ``host_us/step`` of both, the trace valid (``validate_trace``), the
   Prometheus text scraped from a localhost endpoint valid
   (``parse_exposition``), the tracker's TTFT equal to the engine's, the
   PIM counters printed; (b) phase 7's shared-prefix run with the tracker
   on: hit and cold TTFT split into queue, prefill and graph capture; (c)
   the single-engine chaos scenarios of ``launch/chaos_soak.py`` (reduced
   llama3.2-1b) at seeds 0 and 1: every request terminal, no page leaked,
   seed 0 run twice with identical event logs and outputs, every runner's
   captures counted (a degradation's plain horizon captures its own); (d)
   kill and restore: a snapshot at tick 6, a fresh engine restores it and
   finishes with the uninterrupted run's tokens (save and restore ms and
   MB printed); (e) the SLO trace at the bench's configuration
   (``launch/slo_bench.py``) with the kernels and on the plain paths:
   every counter equal to ``BENCH_slo.json``'s; (f) ``step()`` against
   ``run()``: tokens identical. Launches of (a), (d) and (f) equal what
   their decode steps and prefill calls imply.

11. disagg — disaggregated serving on the graph path, llama3.2-1b at full
   width (fp32 weights from seed 0, one copy shared by every engine, page
   16, batched prefill, horizon 4, 4 splits): (a) one prefill and one
   decode engine (``serving/cluster.py``, 8 slots and 1024 pages each, 8
   prompts of 256-1024 tokens, 32 new) against one colocated engine:
   tokens equal (the near-tie rule of phase 5), every request handed off
   once and applied, no failure counter, launches equal what both
   engines' steps and prefill calls imply; prints the handoff MB, the
   extract / encode / decode / apply ms, decode tok/s against the
   colocated engine's, syncs per token and each engine's graph captures;
   (b) ``launch/chaos_soak.py``'s ``disagg`` scenario (engine death
   rebuilt warm from snapshots every 3 ticks on the same card, torn and
   corrupt handoffs, backpressure) at seeds 0, 1, 0 again and 3: terminal,
   leak-free, completed requests held to a clean run, seed 0 replayed
   identically, each dead engine's graphs and state released, each
   rebuilt engine capturing its own graphs, launches per run checked;
   prints device memory at each death and after its rebuild; (c) lazy
   against static allocation through ``launch/serve.py`` at full width (6
   slots, context 2048: 129 pages a static request, a 288-page pool):
   peak pages, avg_batch and decode tok/s of each, static admitting less,
   tokens equal, launches checked.

12. xlstm — the attention-free xLSTM family and the benches as entry points
   of the port: (a) xlstm-350m at full width and depth (24 layers, 12
   mLSTM + sLSTM cycles, random fp32 weights from seed 0; 8 slots, page
   16, 8 prompts of 256-1024 tokens, 32 new, horizon 4) in batched
   prefill on the graph path, eagerly and on the plain path, in slot and
   chunked (128) prefill, and batched on a 120-page pool that preempts
   with snapshots (``state_resume``): tokens equal the batched graph
   run's (the near-tie rule of phase 5), K1-K4 launch 0 times (no Pallas
   kernel is on the reference's xLSTM path), device syncs equal across
   the batched ways, the small pool restores, every page released;
   prints TTFT, decode tok/s, replayed device ms/step, syncs per token and
   peak device memory beside zamba2's phase-5 batched numbers. (b)
   ``launch/serving_bench.py`` in-process at ``BENCH_serving.json``'s
   sizes: its 12 rows, its own asserts, and the counter layer of
   ``benchmarks/check_regression.py::check_serving`` (tokens, syncs per
   token, accept length, the robustness and handoff counters) clean
   against the baseline; the timing layer's messages are printed at the
   default tolerance, not asserted; each row's decode tok/s, TTFT and
   syncs per token printed. (c) ``launch/kvcache_bench.py``'s ``run``: its
   share levels (0 / 50 / 90%) with and without the cache (outputs equal;
   at 90% at least 16 hits and fewer pages; the TTFT ratio printed) and
   its host-tier scenario (admitted KV past the 40-page pool, swaps both
   ways); the rows printed. The benches'
   launches (K1 and K2 on their llama rows) join the totals.

13. families — the enc-dec and M-RoPE families and the ring pool, each at
   full width with random fp32 weights from seed 0, each model freed before
   the next loads: (a) whisper-small whole (12 encoder + 12 decoder
   layers, 8 slots of 16-token pages, 8 prompts of 128-416 tokens, 32
   new, inside its 448 text positions, stub zero frames) batched at
   horizon 4 on the graph path, eagerly and on the plain path, slot and
   chunked (128): tokens equal the graph run's (the near-tie rule of phase
   5); launches by kernel equal what the steps and calls imply: K3 (the
   cross-attention decode, inside the captured horizon) and K1 12 a
   decode step, K2 non-causal (the encoder and the cross prefill) 12 + 12
   a prefill call that runs the encoder, K2 causal 12 a prefill call;
   TTFT, decode tok/s, replayed device ms/step and peak device memory
   printed; kill and restore (snapshot at tick 6 into a fresh engine, the
   cross rows written in place) and a 1 + 1 cluster (pages and cross rows
   handed over) keep the tokens. (b) qwen2-vl-7b whole, batched at horizon
   4 on graphs against the plain path (tokens); at the model level 4 rows
   of a 16 x 16 image grid (distinct t / h / w ids, ``extra_embeds``) and
   64 text positions, 8 decode steps: kernel against plain logits (3e-4
   prefill, 4e-3 decode, of max(1, |logits|)). (c) mixtral-8x22b's first
   2 of 56 layers (window 4096): 4 slots, slot prefill, prompts of
   4600-6000 tokens, 32 new, on ``Runtime(ring_width=258)`` against the
   full pool (tokens, peak pages); at the model level 6000 + 8 tokens in
   258 ring pages against 376 (logits within 2e-4). The whisper and
   qwen2-vl main-path launches join the totals; the ``kernels`` line's K3
   count is whisper's serving launches plus the bench's.

14. train — training on the card (``models.model.train_loss``,
   ``training/``, ``launch/train.py``), random fp32 weights from seed 0.
   No kernel is on this path (none of the port's kernels has a backward;
   repro's training path reaches no Pallas kernel): each run's K1-K4
   launches must be 0. (a) llama3.2-1b whole (16 layers, d 2048, vocab
   128256, tied), ``Runtime(remat=True)``, AdamW lr 1e-3 warmup 1, 8 steps
   of B 8 x S 512 on ``TrainPipeline``'s batch 0 repeated: step ms (CUDA
   events), tokens/s, peak device memory, loss and grad norm by step; all
   finite, the last loss below the first. (b) reduced llama, zamba2,
   mixtral and xlstm, the same seeded params on the card and the CPU: 3
   steps' losses within 1e-5 relative, the first step's grads within 1e-4
   of each leaf's largest magnitude, AdamW's update from the same grads
   within 1e-6 (the free-running params' gap printed, ROADMAP C.11). (c) reduced llama, 2 microbatches against 1: params
   within 5e-5. (d) reduced llama, 10 steps against 6 with a checkpoint
   every 3, ``restore`` onto the card and 4 more, deterministic
   algorithms on: losses rtol 1e-6, params atol 1e-6. (e) zamba2-1.2b
   whole, remat, 3 steps of B 4 x S 512: finite, step ms and peak memory.
   (f) ``launch.train`` in process at ``examples/train_100m.py``'s
   settings (d 768, 12 layers, vocab 8192, S 256, B 8), 20 steps with
   checkpoints every 10, then a restart from step 9 that resumes; the
   loss lines printed. (g) full-width llama3.2-1b batched at horizon 4: an
   engine with a host ``sample=`` greedy callable (the eager horizon) gives
   the graph path's tokens (the near-tie rule of phase 5), its launches
   checked and added to the totals; ``decode_graphs=True`` with
   ``sample=`` raises; int8 weight-only params (``core/quant.py``): prefill
   and 8 decode steps on K2 / K1, logits within ``tests/test_quant.py``'s
   bound (0.12 of their spread, greedy agreement >= 0.75) of the fp32
   ones. Phase 3 also times SDPA with an explicit boolean band mask (the
   window) as K2's library call at its windowed shapes.
15. sharded — the multi-device serving paths on a single-process 8-shard
   ``LocalMesh`` (fp32, TF32 off, greedy), each case's launches checked
   against what its steps and calls imply and added to the totals: (a)
   long_500k: gemma3-27b's first 6 layers at full width, one request of
   524288 tokens in pages of 256 striped over (data 2, model 4) and merged
   over both, the 51.5 GB pool seeded and viewed by every shard (no copy),
   4 decode steps through ``sharding.make_decode_step`` (the dense layers
   as Megatron TP over ``model`` on each shard's serve slices): K1 on each
   shard's local table, ``windowed_slice`` on the 5 local layers
   (``cond_window`` 1024); held to the unsharded step (K1 at ``n_splits``
   64) on the same pool fed the same tokens (logits 1e-5 of scale, greedy
   tokens by C.3); the global layer's K1 over 8 shards and in one launch
   against its byte bound. (b) llama3.2-1b whole, 8 rows of
   256-1024 tokens over (data 2, model 4), ``row_affine`` +
   ``blocked_chunk``: repro's prefill cell (``sharding.make_prefill_step``,
   ``sp``, FSDP weights; K2 at each shard's ``q_offset`` against its rows'
   gathered K/V, 16 layers x 8 shards; each shard writes the pages it
   owns) against the unsharded kernel prefill (logits and pool pages
   within 1e-4 of scale), then 32 decode steps of ``make_decode_step``
   (TP over ``model``, ITPP merged over ``model``) against the unsharded
   K1 step (logits 1e-5 of scale). (c) mixtral-8x22b's MoE layer at
   full width on ``moe_ep`` (8 virtual experts on 8 shards, dropless, 8 x
   64 tokens; the prefill shard runtime's MoE) against ``moe_local``
   (2e-5 of scale; aux = the shards' plain mean). (d) GPipe decode of
   llama3.2-1b whole on (pod 2, data 2, model 2), 2 stages, 2
   microbatches, B 4, 256 prefilled tokens and 16 steps, each stage TP
   over ``model`` on the serve slices, against the unsharded step (logits
   1e-5 of scale) and ``forward`` (5e-3).

16. train-sharded — ``make_train_step`` on a single-process mesh
   (``Plan.make_runtime(mode="train")``, fp32, remat, AdamW lr 1e-3),
   each case's first step held to the unsharded step on the same batch
   (loss and grad norm within 1e-5 relative, AdamW's first moments, the
   clipped grads, within 1e-4 of each leaf's scale), no kernel launched:
   (a) llama3.2-1b whole, B 8 x S 512, ``fsdp`` on (data 2, model 4); (b)
   the same in ``sp`` at B 2 x S 512 (K/V gathered over ``model`` inside
   backward); (c) phi3.5-moe's first layer at full width on ``moe_ep``
   (16 experts on (data 1, model 16), ``all_to_all`` inside backward),
   against the single-device step whose aux is the shards' mean; step ms,
   tokens/s and peak memory. Then one dry-run
   cell per shape kind on this machine's CPU (meta tensors) with its
   roofline terms at the card's datasheet figures.
   Phases 15 and 16 call the steps in the resident form (``Plan.shard``
   at the start, ``Plan.gather`` where they compare), the identity on a
   ``LocalMesh``.

17. mesh — a ``ProcessMesh`` on the card: two ranks (data 1, model 2),
   two processes on the one H100 started by this script (``--mesh-rank``)
   over gloo on a localhost port, their collectives' CUDA tensors staged
   through host memory (NCCL refuses two ranks on one device; the compute
   stays on the card), each holding only its own part of the state
   (``Plan.shard``), deterministic algorithms on. (a) llama3.2-1b at
   full width, fp32, random weights from seed 0: the sharded prefill of
   phase 15 (b)'s 8 rows (``sp``, FSDP slices), then 8 resident decode
   steps (TP over ``model`` on the serve slices, ITPP on the rank's page
   block, written in place); (b) 3 resident ``fsdp`` train steps at B 8 x
   S 512. Each rank prints the device memory (``memory_allocated``) of
   its serve slices, FSDP slices, pool block, and params + moments
   beside the plan's count of its slices (held within 1%) and the whole
   tree, its step ms and the bytes staged through the host, and holds K1
   on its own page block (its pages, then its trash page; the local
   table) against its plain version (``TOL``). Launches a rank: K2 16,
   K1 16 x 8. Rank 0 gathers the results and holds them to the same
   steps on a ``LocalMesh`` (1, 2) in its process: greedy tokens
   identical (C.3), logits and pool pages within 1e-5 of scale, losses
   and grad norms 1e-5 relative, params and first moments 1e-4 of each
   leaf's scale. (c) a second mesh over the same two processes, (pod 2,
   data 1, model 1): phase 15 (d)'s pipeline at full width (B 4, 256
   prompt tokens through the unsharded prefill, K2 16 a rank), each rank
   holding only its own stage's 8 of the 16 layers (``stage_specs``)
   and its stage's pool block, then 8 greedy decode steps of 2
   microbatches (K1 8 x 2 x 8 a rank); each rank prints the device
   memory of its stage's params and pool block beside the plan's count
   and the whole, its step ms and staged bytes, and holds K1 on its
   stage block against its plain version. Rank 0 holds the gathered
   logits and pool pages bit-equal to the same pipeline on a
   ``LocalMesh`` (2, 1, 1), and its greedy tokens to the unsharded
   step's (C.3; logits within 1e-5 of scale). A rank that fails fails
   the phase; both are stopped.

``python3 chip_smoke.py --lifecycle`` builds the kernels and runs phase 10
alone; ``--disagg`` builds them and runs phase 11 alone; ``--xlstm``
phase 12 alone; ``--families`` phase 13 alone; ``--train`` phase 14
alone; ``--sharded`` phase 15 alone; ``--train-sharded`` phase 16 alone;
``--mesh`` phase 17 alone; ``--kernels`` phase 3 alone.
``python3 chip_smoke.py --kernel-times SRC`` only times K1 (pages of 16
and 256 tokens), K2 (the llama, zamba2 and chunked shapes), K3 (the
bench and long-context shapes) and K4 (zamba2 prefill and decode, slot
and chunked prefill) of the package under ``SRC``, each in fp32 and
bf16, against their plain versions: run it on two checkouts in turns
(parent, change, change, parent) in one call to compare two versions.
``--paged-times SRC`` prints its fp32 page-16 K1 lines alone.
``--k4-ablation`` builds K4's timing variants (``ssm_scan.cu``'s
``SSM_ABLATE`` bits: without the score / W / S v loop, without W's exp,
without the state update; bf16 q k^T as one TF32 product) and times each
against the whole kernel at zamba2's prefill shape.

The last three lines: the card's name and power limit, one JSON object
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import ctypes
import gc
import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parent
DEV = "cuda"
HBM_BYTES_S = 3.35e12                       # H100 SXM device memory
PEAK = {torch.float32: 67e12,               # fp32 outside the tensor cores
        torch.bfloat16: 989e12}             # bf16 tensor cores, dense
TF32X3 = 495e12 / 3                         # fp32 routes: 3 TF32 products
TF32X2 = 495e12 / 2                         # K4, bf16 v: 2 TF32 products
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
SSM_TOL = 2e-5                              # of the largest magnitude
TIE_GAP = 1e-5                              # ROADMAP C.3 near-tie rule


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call from CUDA events, after warm-up, over at least
    ``iters`` calls and, for a short kernel, as many more as fill ~20 ms
    (a hiccup of the host or the card then weighs little)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(2):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        if ms * iters >= 10.0:
            return ms
        iters = min(2000, max(iters, int(20.0 / max(ms, 1e-3))))
    return ms


def graph_ms(fn, calls: int = 20) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, replayed (after a warm-up replay) until ~20 ms have passed,
    timed by CUDA events. Unlike ``cuda_ms`` it leaves out the host's
    dispatch, which is longer than a short kernel's run."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reps = 1
    for _ in range(2):
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / (reps * calls)
        if ms * reps * calls >= 10.0:
            break
        reps = min(500, max(reps, int(20.0 / max(ms * calls, 1e-3))))
    del graph
    return ms


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        print("[device] torch.cuda.is_available() is False: no card",
              file=sys.stderr)
        sys.exit(2)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"need compute capability 9.0 (Hopper), got {cap}")
    # fp32 products stay full fp32 (no TF32) so the kernel paths can be
    # held to the plain paths at fp32 tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} sm_{cap[0]}{cap[1]} "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} | nvidia-smi: {smi}", flush=True)
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    res = build.build_all()
    dt = time.perf_counter() - t0
    print(f"[build] nvcc {' '.join(build.FLAGS)}: {len(res)} sources in "
          f"{dt:.1f} s (" + ", ".join(f"{n} done at {r['seconds']:.1f} s"
                                      for n, r in res.items()) + ")",
          flush=True)
    # the kernels take their shared memory dynamically (ptxas does not
    # report it), at the main-path shapes: paged_attention G=4 rows at D 64
    # and D 128 and flash_decode G=4 at D 128 and 64 (a ring of two K/V
    # stages whatever the page or split size; the larger of the fp32 and
    # bf16 needs); flash_attention at D 64 (64 query rows, 64-token K/V
    # stages); ssm_scan N=P=64: the chunk kernel at chunk 128 (64 P columns
    # a block) and the step kernel (chunk 1)
    from repro_torch.kernels.flash_attention import _lib as fa_lib
    from repro_torch.kernels.flash_decode import _lib as fd_lib
    from repro_torch.kernels.paged_attention import _lib as pa_lib
    from repro_torch.kernels.ssm_scan import _lib as ssm_lib
    smem = ssm_lib().ssm_chunk_scan_smem
    pa, fd = pa_lib().paged_attention_smem, fd_lib().flash_decode_smem
    fa = fa_lib().flash_attention_smem
    print(f"[build] dynamic shared memory: paged_attention {pa(4, 64)} B "
          f"(D 64) / {pa(4, 128)} B (D 128), flash_decode {fd(4, 128)} B "
          f"(D 128) / {fd(4, 64)} B (D 64), flash_attention {fa(0, 64)} B "
          f"(fp32) / {fa(1, 64)} B (bf16), ssm_scan "
          f"{smem(0, 64, 64, 128, 64)} B (chunk 128, fp32) / "
          f"{smem(1, 64, 64, 128, 64)} B (chunk 128, bf16) / "
          f"{smem(0, 64, 64, 1, 64)} B (chunk 1) per block", flush=True)
    for name, r in res.items():
        for line in r["log"].splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                print(f"[build] {name}: {line.strip()}")
    sys.stdout.flush()
    tensor_core_check(build)


def sass_counts(build, tool, lib: str, prefixes) -> dict:
    """Tensor-core instructions (``HGMMA``, ``HMMA``) per kernel whose
    mangled name holds one of ``prefixes``, from ``cuobjdump -sass`` of
    the built library ``lib``."""
    import re
    out = subprocess.run([str(tool), "-sass", str(build._target(lib))],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass failed: {out.stderr.strip()[:400]}")
    counts, cur = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = (m.group(1) if any(p in m.group(1) for p in prefixes)
                   else None)
            if cur:
                counts[cur] = {"HGMMA": 0, "HMMA": 0}
        elif cur:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[cur][op] += 1
    if not counts:
        fail(f"cuobjdump found no {'/'.join(prefixes)} kernel in {lib}")
    return counts


def tensor_core_check(build) -> None:
    """``cuobjdump -sass`` of the built K2 and K4 libraries: each
    instantiation of K2 must hold tensor-core instructions, ``HGMMA``
    (wgmma) for bf16 inputs and ``HMMA`` (mma.sync, the 3xTF32 route) for
    fp32; each of K4's chunk kernel ``HMMA`` (its step kernel, the decode
    route, is bound by bytes and has none)."""
    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        print("[build] cuobjdump is not in the toolkit: the tensor-core "
              "checks of flash_attention and ssm_scan were not made",
              flush=True)
        return
    for fn, c in sass_counts(build, tool, "flash_attention",
                             ("flash_fwd_",)).items():
        bf16 = "bf16" in fn
        tag = "bf16" if bf16 else "fp32"
        name = fn[fn.index("flash_fwd_"):][:48]
        print(f"[build] flash_attention SASS {tag} {name}: "
              f"HGMMA={c['HGMMA']} HMMA={c['HMMA']}", flush=True)
        if (bf16 and not c["HGMMA"]) or (not bf16 and not c["HMMA"]):
            fail(f"K2 instantiation {fn} has no tensor-core instructions")
    counts = sass_counts(build, tool, "ssm_scan",
                         ("ssm_chunk_kernel", "ssm_step_kernel"))
    for fn, c in counts.items():
        kind = ("ssm_chunk_kernel" if "ssm_chunk_kernel" in fn
                else "ssm_step_kernel")
        name = fn[fn.index(kind):][:64]
        print(f"[build] ssm_scan SASS {name}: HGMMA={c['HGMMA']} "
              f"HMMA={c['HMMA']}", flush=True)
        if kind == "ssm_chunk_kernel" and not (c["HMMA"] or c["HGMMA"]):
            fail(f"K4 instantiation {fn} has no tensor-core instructions")
    if not any("ssm_chunk_kernel" in fn for fn in counts):
        fail("cuobjdump found no ssm_chunk_kernel in the K4 library")


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------

def _pool_case(rng, dev, dtype, B, KVH, G, D, page, W, *, ctx_max, qpos=1,
               ctx_fixed=None):
    P = B * W + 1
    q = torch.randn(B, KVH, G * qpos, D, device=dev).to(dtype)
    kp = torch.randn(P, page, KVH, D, device=dev).to(dtype)
    vp = torch.randn(P, page, KVH, D, device=dev).to(dtype)
    bt = torch.from_numpy(rng.permutation(P)[:B * W].reshape(B, W)
                          .astype(np.int32)).to(dev)
    ctx = (rng.integers(1, ctx_max + 1, B) if ctx_fixed is None
           else np.full(B, ctx_fixed))
    return q, kp, vp, bt, torch.from_numpy(ctx.astype(np.int32)).to(dev)


def _table_tokens(bt, ctx, page: int, window: int,
                  windowed_slice: bool) -> float:
    """The tokens a decode launch (qpos 1) must read from its table: of
    each live slot's page (slot j is virtual page j, or lo + j under
    ``windowed_slice``), those in the row's [ctx - window, ctx)."""
    bt, ctx = bt.long().cpu(), ctx.long().cpu()[:, None]
    lo_tok = (ctx - window).clamp_min(0) if window else torch.zeros_like(ctx)
    vp = torch.arange(bt.shape[1])[None]
    if windowed_slice:
        vp = lo_tok // page + vp
    a = torch.maximum(vp * page, lo_tok)
    b = torch.minimum((vp + 1) * page, ctx)
    return float(((b - a).clamp_min(0) * (bt >= 0)).sum())


def _shard_case(dev, dtype, *, KVH, G, D, page, n_pages, n_shards, my,
                admit, rows, ctx, maxp, policy, alloc_kw=None, row_of=None,
                window=0, win_slots=0):
    """One shard's K1 inputs on a page-sharded pool, as
    ``core/itpp.py`` passes them: the rows ``rows`` of the global tables
    of requests admitted with ``admit`` tokens (at context ``ctx``, one
    entry a request), the shard's ``n_pages //
    n_shards`` pages as a view of the whole pool (trash page last), its
    pages renumbered locally and every other entry -1; with ``win_slots``
    only that many slots from the window's first page (``windowed_slice``).
    """
    from repro_torch.core.allocator import PageAllocator
    alloc = PageAllocator(n_pages, n_shards, page, policy=policy,
                          **(alloc_kw or {}))
    for b, n in enumerate(admit):
        alloc.admit(b, int(n), **({} if row_of is None
                                  else {"row": row_of(b)}))
    bt = np.stack([alloc.block_table(b, maxp) for b in rows]).astype(np.int64)
    P_loc = n_pages // n_shards
    bt = np.where((bt >= 0) & (bt // P_loc == my), bt - my * P_loc, -1)
    ctx = np.asarray(ctx, dtype=np.int64)[rows]
    if win_slots:
        sel = (np.maximum(ctx - window, 0) // page)[:, None] \
            + np.arange(win_slots)[None]
        bt = np.where(sel < maxp,
                      np.take_along_axis(bt, np.minimum(sel, maxp - 1), 1),
                      -1)
    pool = [torch.randn(n_pages + 1, page, KVH, D, device=dev).to(dtype)
            for _ in "kv"]
    kp, vp = (t.narrow(0, my * P_loc, P_loc) for t in pool)
    q = torch.randn(len(rows), KVH, G, D, device=dev).to(dtype)
    return (q, kp, vp, torch.from_numpy(bt.astype(np.int32)).to(dev),
            torch.from_numpy(ctx.astype(np.int32)).to(dev))


def check_paged(rng, dtype, *, B=8, KVH=8, G=4, D=64, page=16, W=128,
                ctx_max=2048, n_splits=1, window=0, ring_width=0,
                windowed_slice=False, qpos=1, idle_row=False, time_it=False,
                ctx_fixed=None, shard=None, inputs=None):
    """K1 against its plain version on a random pool, or, with ``shard``
    (``_shard_case``'s arguments), on one shard's view of a page-sharded
    pool, or on ``inputs`` (q, k / v pages, local table, ctx: phase 17's
    rank block); a shard case's bound counts the tokens its table holds."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels.ref import combine_partials
    from repro_torch.kernels.backend import decode_hbm_bytes
    dev = DEV
    if inputs is not None:
        q, kp, vp, bt, ctx = inputs
        B, W = bt.shape
        KVH, G, D, page = q.shape[1], q.shape[2], q.shape[3], kp.shape[1]
    elif shard is None:
        q, kp, vp, bt, ctx = _pool_case(rng, dev, dtype, B, KVH, G, D, page,
                                        W, ctx_max=ctx_max, qpos=qpos,
                                        ctx_fixed=ctx_fixed)
    else:
        q, kp, vp, bt, ctx = _shard_case(dev, dtype, KVH=KVH, G=G, D=D,
                                         page=page, window=window, **shard)
        B, W = bt.shape
    if idle_row:                     # ctx 0, all -1 table: every split dead
        bt[-1] = -1
        ctx[-1] = 0
    win = torch.full((B,), window, dtype=torch.int32, device=dev)
    kw = dict(ring_width=ring_width, windowed_slice=windowed_slice,
              n_splits=n_splits, qpos=qpos)

    def kern():
        return PA.paged_attention_partials(q, kp, vp, bt, ctx, window=win,
                                           **kw)

    def plain():
        return PA.paged_attention_partials_plain(q, kp, vp, bt, ctx, win,
                                                 **kw)

    def merged(parts):
        o, l, _ = combine_partials(*parts)
        return o / l.clamp_min(1e-30)[..., None]

    got, want = kern(), plain()
    torch.cuda.synchronize()
    out_k, out_p = merged(got), merged(want)
    if not torch.isfinite(out_k).all():
        fail("paged_attention_partials: non-finite output")
    if idle_row and not torch.all(out_k[-1] == 0):
        fail("paged_attention_partials: idle row is not 0")
    err = (out_k - out_p).abs().max().item()
    lerr = ((got[1] - want[1]).abs() / want[1].abs().clamp_min(1)).max().item()
    merr = (got[2] - want[2]).abs().max().item()
    tol = TOL[dtype]
    ok = err <= tol and lerr <= tol and merr <= tol
    res = {"max_abs_err": err, "ok": ok}
    if time_it:
        res["ms"] = cuda_ms(kern)
        res["graph_ms"] = graph_ms(kern)
        res["plain_ms"] = cuda_ms(plain, iters=5)
        esz = torch.finfo(dtype).bits // 8
        S = max(1, min(n_splits, W))
        # row t of a slot's qpos rows sees ctx + t tokens (of the W * page
        # its table holds; a ring's table holds the last W pages of any
        # ctx), only the last `window` of them under a window; the tokens
        # read run from the first row's lowest to the last's end
        c = ctx.long().cpu()[:, None] + torch.arange(qpos)[None]
        hi = c if ring_width else c.clamp(0, W * page)
        lo = (c - window).clamp_min(0) if window else torch.zeros_like(c)
        seen = float((hi - lo).clamp_min(0).sum())
        live = float((hi[:, -1] - lo[:, 0]).clamp_min(0).sum())
        if shard is not None or inputs is not None:   # sparse tables:
            # the tokens they hold
            live = seen = _table_tokens(bt, ctx, page, window,
                                        windowed_slice)
        nbytes = (decode_hbm_bytes(live, KVH, D, esz) + q.numel() * esz
                  + S * B * KVH * G * qpos * (D + 2) * 4
                  + bt.numel() * 4 + ctx.numel() * 4)
        flops = 4.0 * KVH * G * D * seen
        # fp32 products at the 3xTF32 rate, as K2's and K4's fp32 bounds
        peak = TF32X3 if dtype == torch.float32 else PEAK[dtype]
        res["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_S, flops / peak)
        res["bound_by"] = ("bytes" if nbytes / HBM_BYTES_S
                           >= flops / peak else "operations")
        if dtype == torch.float32:
            res["bound_ms_cuda_cores"] = 1e3 * max(
                nbytes / HBM_BYTES_S, flops / PEAK[dtype])
    return res


def _causal_pairs(B, Sq, Skv, offs, window) -> float:
    total = 0
    for b in range(B):
        pos = offs[b] + np.arange(Sq)
        hi = np.minimum(pos, Skv - 1)
        lo = np.maximum(0, pos - window + 1) if window else np.zeros_like(pos)
        total += int(np.maximum(hi - lo + 1, 0).sum())
    return float(total)


def check_flash(dtype, *, B=2, Sq=1024, Skv=1024, H=32, KVH=8, D=64,
                offs=None, window=0, causal=True, time_it=False):
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_plain)
    dev = DEV
    offs = (0,) * B if offs is None else offs
    q = torch.randn(B, Sq, H, D, device=dev).to(dtype)
    k = torch.randn(B, Skv, KVH, D, device=dev).to(dtype)
    v = torch.randn(B, Skv, KVH, D, device=dev).to(dtype)
    off = torch.tensor(offs, dtype=torch.int32, device=dev)

    def kern():
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   q_offset=off)

    def plain():
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=off)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail("flash_attention_fwd: non-finite output")
    err = (got.float() - want.float()).abs().max().item()
    res = {"max_abs_err": err, "ok": err <= TOL[dtype]}
    if time_it:
        res["ms"] = cuda_ms(kern)
        res["plain_ms"] = cuda_ms(plain, iters=5)
        esz = torch.finfo(dtype).bits // 8
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * esz
        pairs = (_causal_pairs(B, Sq, Skv, offs, window) if causal
                 else float(B * Sq * Skv))
        flops = 4.0 * H * D * pairs
        peak = TF32X3 if dtype == torch.float32 else PEAK[dtype]
        res["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_S, flops / peak)
        res["bound_by"] = ("bytes" if nbytes / HBM_BYTES_S
                           >= flops / peak else "operations")
        if dtype == torch.float32:
            res["bound_ms_cuda_cores"] = 1e3 * max(
                nbytes / HBM_BYTES_S, flops / PEAK[dtype])
        if not any(offs) and (Sq == Skv or not causal):
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            if window:
                # a window has no SDPA flag: an explicit boolean band
                # mask [Sq, Skv] (causal and the window) computes the same
                # function in one call
                i = torch.arange(Sq, device=dev)[:, None]
                j = torch.arange(Skv, device=dev)[None]
                band = (j <= i) & (j > i - window)
                res["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=band, enable_gqa=True))
                res["library"] = "sdpa band mask"
            else:
                res["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True))
        elif causal:
            # per-row offsets (a chunk, a sharded prefill's shard) have no
            # SDPA flag: a boolean mask [B, 1, Sq, Skv] built from each
            # row's q_offset (and the window) computes the same function
            # in one call; held to the plain version as the kernel is
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            pos = off.long()[:, None, None] + torch.arange(
                Sq, device=dev)[None, :, None]
            j = torch.arange(Skv, device=dev)[None, None]
            mask = j <= pos
            if window:
                mask &= j > pos - window
            mask = mask[:, None]

            def lib():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
            res["library_err"] = (lib().transpose(1, 2).float()
                                  - want.float()).abs().max().item()
            if res["library_err"] > TOL[dtype]:
                fail(f"SDPA with the q_offset mask misses the plain version "
                     f"by {res['library_err']:.3e}")
            res["library_ms"] = cuda_ms(lib)
            res["library"] = "sdpa q_offset mask"
    return res


# K1 and K2 at the head layouts of the model zoo, D 128: qwen1.5-7b (32 kv
# heads, one query head each), gemma3-27b (16 / 2; its local layers'
# 1024-token window), phi3.5-moe (8 / 4), yi-34b (8 / 7) and qwen2-vl-7b
# (4 / 7); K1 at 8 slots of up to 2048 tokens in 16-token pages, also
# qwen's verify pass at qpos 5; K2 at Sq = Skv = 1024, gemma3 also as a
# chunk at per-row offsets against 2048 keys. mixtral-8x22b (8 / 6, window
# 4096) as phase 13 (c) serves it: K1 on the ring of 258 pages (4 slots,
# ctx 6000 wraps it; random ctx up to 6000), K2 as its slot prefill of
# 6000 tokens (ragged against the 64-token tiles)
ZOO_PAGED = (
    ("qwen1.5-7b decode KVH=32 G=1 D=128", dict(KVH=32, G=1)),
    ("gemma3-27b local decode KVH=16 G=2 D=128 window=1024",
     dict(KVH=16, G=2, window=1024)),
    ("gemma3-27b global decode KVH=16 G=2 D=128", dict(KVH=16, G=2)),
    ("phi3.5-moe decode KVH=8 G=4 D=128", dict(KVH=8, G=4)),
    ("yi-34b decode KVH=8 G=7 D=128", dict(KVH=8, G=7)),
    ("qwen1.5-7b verify qpos=5 KVH=32 G=1 D=128",
     dict(KVH=32, G=1, qpos=5)),
    ("qwen2-vl-7b decode KVH=4 G=7 D=128", dict(KVH=4, G=7)),
    ("mixtral-8x22b ring decode B=4 KVH=8 G=6 D=128 window=4096 "
     "ring_width=258 ctx=6000", dict(B=4, KVH=8, G=6, W=258, ring_width=258,
                                     window=4096, ctx_fixed=6000)),
    ("mixtral-8x22b ring decode B=4 KVH=8 G=6 D=128 window=4096 "
     "ring_width=258 ctx<=6000", dict(B=4, KVH=8, G=6, W=258, ring_width=258,
                                      window=4096, ctx_max=6000)))
# K1 on shard-local tables at the layouts phase 15 launches it: (a)
# long_500k's gemma3-27b request striped over 8 shards (a shard's 256-page
# view, its 256 of the 2048 slots live; the local layers' windowed_slice
# over 6 slots, at the shard holding the window's 3-token first page and at
# the one holding the current page), (b)'s llama3.2-1b rows (row_affine,
# blocked_chunk 16; a shard with ragged tables and one whose tables are all
# -1) and (d)'s pipeline stage (1 row, 24-page view, 18 slots)
LONG_SHARD = dict(n_pages=2048, n_shards=8, admit=[524288], rows=[0],
                  ctx=[524285], maxp=2048, policy="striped")
_B_LENS = np.random.default_rng(15).integers(256, 1025, 8)
B_SHARD = dict(n_pages=768, n_shards=8, admit=_B_LENS + 32, ctx=_B_LENS + 1,
               maxp=67, policy="row_affine",
               alloc_kw=dict(n_rows=2, blocked_chunk=16),
               row_of=lambda b: b // 4)
SHARD_PAGED = (
    ("gemma3-27b long_500k global shard 3/8 view 256 pages of 256, table "
     "2048 slots (256 live) ctx=524285 KVH=16 G=2 D=128 n_splits=16",
     dict(KVH=16, G=2, D=128, page=256, n_splits=16,
          shard=dict(LONG_SHARD, my=3))),
    ("gemma3-27b long_500k local windowed_slice shard 3/8 (window's first "
     "page, 3 tokens) 6 slots window=1024 ctx=524285 n_splits=16",
     dict(KVH=16, G=2, D=128, page=256, n_splits=16, window=1024,
          windowed_slice=True, shard=dict(LONG_SHARD, my=3, win_slots=6))),
    ("gemma3-27b long_500k local windowed_slice shard 7/8 (current page) "
     "6 slots window=1024 ctx=524285 n_splits=16",
     dict(KVH=16, G=2, D=128, page=256, n_splits=16, window=1024,
          windowed_slice=True, shard=dict(LONG_SHARD, my=7, win_slots=6))),
    ("llama3.2-1b decode_32k rows 0-3 shard 3/8 view 96 pages of 16, "
     "table 67 slots (ragged) KVH=8 G=4 D=64 n_splits=4",
     dict(KVH=8, G=4, D=64, page=16, n_splits=4,
          shard=dict(B_SHARD, my=3, rows=[0, 1, 2, 3]))),
    ("llama3.2-1b decode_32k rows 4-7 shard 7/8 (every entry -1) "
     "n_splits=4",
     dict(KVH=8, G=4, D=64, page=16, n_splits=4,
          shard=dict(B_SHARD, my=7, rows=[4, 5, 6, 7]))),
    ("llama3.2-1b pipeline stage row 0 shard 1/4 view 24 pages of 16, "
     "table 18 slots ctx=257 n_splits=1",
     dict(KVH=8, G=4, D=64, page=16, n_splits=1,
          shard=dict(n_pages=96, n_shards=4, admit=[272] * 4, rows=[0],
                     ctx=[257], maxp=18, policy="row_affine",
                     alloc_kw=dict(n_rows=2), row_of=lambda b: b % 2, my=1))))
ZOO_FLASH = (
    ("qwen1.5-7b H=KVH=32 D=128 Sq=1024", dict(H=32, KVH=32)),
    ("gemma3-27b H=32 KVH=16 D=128 Sq=1024 window=1024",
     dict(H=32, KVH=16, window=1024)),
    ("gemma3-27b H=32 KVH=16 D=128 Sq=1024 (global)", dict(H=32, KVH=16)),
    ("gemma3-27b H=32 KVH=16 D=128 Sq=1024 Skv=2048 q_offset=[1024,512] "
     "window=1024", dict(H=32, KVH=16, Skv=2048, offs=(1024, 512),
                         window=1024)),
    ("phi3.5-moe H=32 KVH=8 D=128 Sq=1024", dict(H=32, KVH=8)),
    ("yi-34b H=56 KVH=8 D=128 Sq=1024", dict(H=56, KVH=8)),
    ("qwen2-vl-7b H=28 KVH=4 D=128 Sq=1024", dict(H=28, KVH=4)),
    ("mixtral-8x22b slot prefill B=1 H=48 KVH=8 D=128 Sq=Skv=6000 "
     "window=4096", dict(B=1, Sq=6000, Skv=6000, H=48, KVH=8, window=4096)))

# K4 at the shapes zamba2-1.2b serves (H 64, N = P = 64): batched prefill,
# the decode step, slot prefill (one row) and chunked prefill (chunk 128)
SSM_SHAPES = (("zamba2 prefill B=8 S=1024 chunk=128", dict()),
              ("zamba2 decode B=8 S=1 chunk=1", dict(S=1, chunk=1)),
              ("slot prefill B=1 S=1024 chunk=128", dict(B=1)),
              ("chunked prefill B=8 S=128 chunk=128", dict(S=128)))


def check_ssm(dtype, *, p_slice=None, **kw):
    """``_check_ssm`` with K4's chunk kernel at ``p_slice`` P columns a
    block in place of its rule's choice (None keeps the rule)."""
    if p_slice is None:     # (a parent checkout's wrapper may have no rule)
        return _check_ssm(dtype, **kw)
    from repro_torch.kernels import ssm_scan
    rule = ssm_scan.default_p_slice
    ssm_scan.default_p_slice = lambda *_: p_slice
    try:
        return _check_ssm(dtype, **kw)
    finally:
        ssm_scan.default_p_slice = rule


def _check_ssm(dtype, *, B=8, S=1024, H=64, N=64, P=64, chunk=128,
               masked=False, time_it=False):
    """K4 against its plain version on Mamba2-like inputs: q/k shared by
    every head (stride-0 views, as ``mamba_forward`` passes them), decays
    -softplus(z), a non-zero carried (C, n) state. ``ms`` is an eager
    call's time, as for every kernel; ``graph_ms`` the device time of a
    call from CUDA-graph replays (the decode step's host dispatch is longer
    than its kernel)."""
    from repro_torch.kernels.ssm_scan import (ssm_chunk_scan,
                                              ssm_chunk_scan_plain)
    from repro_torch.models.ssm import mask_log_gates_tail
    g = torch.Generator(device=DEV).manual_seed(S + B)

    def f(*shape):
        return torch.randn(shape, generator=g, device=DEV)
    q, k = (f(B, S, 1, N).to(dtype).expand(B, S, H, N) for _ in "qk")
    v = f(B, S, H, P).to(dtype)
    la, lg = -F.softplus(f(B, S, H)), f(B, S, H) * 0.1
    st = (f(B, H, N, P) * 0.3, f(B, H, N) * 0.3)
    if masked is True:
        vl = torch.randint(1, S + 1, (B,), generator=g, device=DEV)
    else:               # False, or one valid length for every row
        vl = (torch.full((B,), int(masked), device=DEV) if masked
              else None)
    ma, mg = (la, lg) if vl is None else mask_log_gates_tail(la, lg, vl)
    def kern():
        return ssm_chunk_scan(q, k, v, la, lg, chunk=chunk, state=st,
                              valid_len=vl)

    def plain():
        return ssm_chunk_scan_plain(q, k, v, ma, mg, chunk=chunk, state=st)

    (y, (C, n)), (yp, (Cp, np_)) = kern(), plain()
    torch.cuda.synchronize()
    if not (torch.isfinite(y).all() and torch.isfinite(C).all()
            and torch.isfinite(n).all()):
        fail("ssm_chunk_scan: non-finite output")
    if vl is not None:          # pad rows of y are garbage by contract
        live = torch.arange(S, device=DEV)[None] < vl[:, None]
        y, yp = y[live], yp[live]
    err = max((a - b).abs().max().item()
              for a, b in ((y, yp), (C, Cp), (n, np_)))
    rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1)).item()
              for a, b in ((y, yp), (C, Cp), (n, np_)))
    res = {"max_abs_err": err, "max_rel_err": rel, "ok": rel <= SSM_TOL}
    if time_it:
        res["ms"] = cuda_ms(kern)
        res["graph_ms"] = graph_ms(kern)
        res["plain_ms"] = cuda_ms(plain, iters=5)
        esz = torch.finfo(dtype).bits // 8
        # each input read once (q/k hold B*S*N values: one row shared by
        # the heads), y and the state written once
        nbytes = (esz * (2 * B * S * N + B * S * H * P) + 4 * 2 * B * S * H
                  + 4 * 2 * (B * H * N * P + B * H * N) + 4 * B * S * H * P)
        # per chunk and (b, h): q k^T and S v on the causal half, q C and
        # k^T v in full
        c = min(chunk, S)
        f_qk = B * H * (S // c) * c * (c + 1) * N
        f_rest = B * H * (S // c) * (c * (c + 1) * P + 4 * c * N * P)
        flops = f_qk + f_rest
        # the chunk route's rates: three TF32 products a product for fp32
        # inputs; for bf16, q k^T on bf16 mma and the others two TF32
        # products each (the step route is bound by bytes)
        t_ops = (flops / TF32X3 if dtype == torch.float32
                 else f_qk / PEAK[torch.bfloat16] + f_rest / TF32X2)
        res["bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_S, t_ops)
        res["bound_by"] = ("bytes" if nbytes / HBM_BYTES_S >= t_ops
                           else "operations")
        res["bound_ms_cuda_cores"] = 1e3 * max(
            nbytes / HBM_BYTES_S, flops / PEAK[torch.float32])
    return res


def check_flash_decode(dtype, *, B, KVH, G, D, T, S, ctx, time_it=False):
    """K3 against its plain version on the same partials: the merged
    output, l (relative to max(|l|, 1)) and m; dead splits must hold the
    exact sentinel (m = -1e30, l = 0, o = 0) and a ctx = 0 row must merge
    to 0. Timed cases add the bound by live bytes and, as ``library_ms``,
    one ``F.scaled_dot_product_attention`` call on the same tensors, which
    gives the MERGED output (GQA, boolean length mask)."""
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.kernels.ref import merge_flash_partials
    from repro_torch.launch.kernel_bench import attention_bound_us
    g = torch.Generator(device=DEV).manual_seed(T + S)
    q = torch.randn(B, KVH, G, D, generator=g, device=DEV).to(dtype)
    k = torch.randn(B, T, KVH, D, generator=g, device=DEV).to(dtype)
    v = torch.randn(B, T, KVH, D, generator=g, device=DEV).to(dtype)
    c = torch.tensor(ctx, dtype=torch.int32, device=DEV)

    def kern():
        return flash_decode(q, k, v, c, n_splits=S)

    def plain():
        return flash_decode_plain(q, k, v, c, n_splits=S)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    out_k, out_p = merge_flash_partials(*got), merge_flash_partials(*want)
    if not torch.isfinite(out_k).all():
        fail("flash_decode: non-finite merged output")
    dead = (torch.arange(S, device=DEV)[:, None] * -(-T // S)
            >= c.clamp_max(T)[None])                          # [S, B]
    if not (torch.all(got[2][dead] == -1e30) and torch.all(got[1][dead] == 0)
            and torch.all(got[0][dead] == 0)):
        fail("flash_decode: a dead split is not m=-1e30, l=0, o=0")
    if not torch.all(out_k[c == 0] == 0):
        fail("flash_decode: a ctx = 0 row does not merge to 0")
    err = (out_k - out_p).abs().max().item()
    lerr = ((got[1] - want[1]).abs() / want[1].abs().clamp_min(1)).max().item()
    merr = (got[2] - want[2]).abs().max().item()
    tol = TOL[dtype]
    res = {"max_abs_err": err, "ok": err <= tol and lerr <= tol
           and merr <= tol, "dead_splits": int(dead.sum()) * KVH}
    if time_it:
        res["ms"] = cuda_ms(kern)
        res["graph_ms"] = graph_ms(kern)
        res["plain_ms"] = cuda_ms(plain, iters=5)
        esz = torch.finfo(dtype).bits // 8
        live = float(c.clamp_max(T).sum())
        res["bound_ms"] = 1e-3 * attention_bound_us(live, q, S, esz,
                                                    4 * B)
        flops = 4.0 * KVH * G * D * live
        nbytes = 2.0 * live * KVH * D * esz
        res["bound_by"] = ("bytes" if nbytes / HBM_BYTES_S
                           >= flops / PEAK[dtype] else "operations")
        qt = q.reshape(B, KVH * G, 1, D)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(T, device=DEV)[None] < c[:, None].long()
                )[:, None, None]

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)
        res["library_ms"] = cuda_ms(sdpa)
        lib_err = (sdpa().float().reshape(out_k.shape) - out_k).abs().max()
        res["library_err"] = lib_err.item()
    return res


def phase_kernels() -> dict:
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    cases, main = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for name, kw in (
                ("main n_splits=1", dict(n_splits=1, time_it=True)),
                ("main n_splits=4", dict(n_splits=4, time_it=True)),
                ("window=100", dict(window=100, ctx_max=512, W=32)),
                ("ring_width=8", dict(ring_width=8, ctx_max=400, W=8)),
                ("windowed_slice", dict(window=100, windowed_slice=True,
                                        ctx_max=512, W=8, n_splits=2)),
                ("qpos=4", dict(qpos=4, ctx_max=500, W=32, n_splits=3)),
                ("idle row", dict(idle_row=True, ctx_max=300, W=32,
                                  n_splits=4))):
            r = check_paged(rng, dtype, **kw)
            cases.append(("paged_attention", tag, name, r))
            if tag == "fp32" and name == "main n_splits=4":
                main["paged_attention"] = r
        r = check_paged(rng, dtype, KVH=32, G=1, W=81, ctx_max=1056,
                        n_splits=4, time_it=True)
        cases.append(("paged_attention", tag,
                      "zamba2 G=1 KVH=32 n_splits=4", r))
        for name, kw in (
                ("page256 D128 B4 KVH2 G4 W8 (bench)",
                 dict(B=4, KVH=2, G=4, D=128, page=256, W=8, ctx_max=2048,
                      time_it=True)),
                ("page256 D128 n_splits=3", dict(B=4, KVH=2, G=4, D=128,
                                                 page=256, W=8, ctx_max=2048,
                                                 n_splits=3))):
            r = check_paged(rng, dtype, **kw)
            cases.append(("paged_attention", tag, name, r))
        # a speculative round's verify pass at llama3.2-1b's geometry:
        # qpos = spec_horizon + 1 query positions a slot, G * qpos rows (20
        # and 64 at spec_horizon 4 and 15; 132 at qpos 33), one launch a
        # tile of at most 32 rows
        for qp in (5, 16, 33):
            r = check_paged(rng, dtype, qpos=qp, n_splits=4, time_it=True)
            cases.append(("paged_attention", tag,
                          f"verify qpos={qp} rows={4 * qp} n_splits=4", r))
            if tag == "fp32" and qp == 16:
                main["paged_attention_verify"] = r
        if tag == "fp32":
            # the bench's decode-step shape at ctx 262144: a measurement
            # of the split count (B x KVH = 2 blocks at n_splits 1)
            for S in (1, 64):
                r = check_paged(rng, dtype, B=2, KVH=1, G=4, D=32, page=256,
                                W=1025, ctx_max=0, ctx_fixed=262144,
                                n_splits=S, time_it=True)
                cases.append(("paged_attention", tag,
                              f"decode-step ctx=262144 n_splits={S}", r))
        for name, kw in (
                ("bench B4 KVH2 G4 D128 T4001 S8",
                 dict(B=4, KVH=2, G=4, D=128, T=4001, S=8,
                      ctx=[4001, 100, 222, 64], time_it=True)),
                ("tail/dead/ctx=0 B4 KVH2 G4 D64 T1001 S8",
                 dict(B=4, KVH=2, G=4, D=64, T=1001, S=8,
                      ctx=[0, 130, 1001, 5000])),
                ("llama decode B8 KVH8 G4 D64 T32768 S16",
                 dict(B=8, KVH=8, G=4, D=64, T=32768, S=16,
                      ctx=[int(x) for x in np.linspace(8192, 32768, 8)],
                      time_it=True)),
                # whisper-small's cross-attention decode (phase 13's
                # serving path): 8 slots over the 1500 encoder rows, every
                # one live, splits of 188 with the tail split (184) padded
                ("whisper cross decode B8 KVH12 G1 D64 T1500 S8",
                 dict(B=8, KVH=12, G=1, D=64, T=1500, S=8, ctx=[1500] * 8,
                      time_it=True))):
            r = check_flash_decode(dtype, **kw)
            cases.append(("flash_decode", tag, name, r))
            if tag == "fp32" and name.startswith("bench"):
                main["flash_decode"] = r
            if tag == "fp32" and name.startswith("whisper"):
                main["flash_decode serving"] = r
        for name, kw in (
                ("main Sq=1024", dict(time_it=True)),
                ("zamba2 H=KVH=32 Sq=1024", dict(KVH=32, time_it=True)),
                ("q_offset=[0,512] Skv=1536", dict(offs=(0, 512), Skv=1536,
                                                   time_it=True)),
                # the sharded prefill (phase 15 (b)): a shard's 256
                # queries at its q_offset against its rows' 1024 keys
                ("sharded prefill B=4 Sq=256 Skv=1024 "
                 "q_offset=[0,256,512,768]",
                 dict(B=4, Sq=256, offs=(0, 256, 512, 768), time_it=True)),
                # phase 17's ProcessMesh prefill: a rank's 8 rows x 512
                # queries at q_offset 0 (rank 0) or 512 (rank 1) against
                # the rows' gathered 1024 keys; both offsets in one call
                ("process-mesh prefill B=8 Sq=512 Skv=1024 "
                 "q_offset=[0,512]x4",
                 dict(B=8, Sq=512, offs=(0, 512) * 4, time_it=True)),
                # the pipeline's unsharded prefill (phase 15 (d), phase 17
                # (c)): 4 rows of 256 tokens
                ("pipeline prefill B=4 Sq=Skv=256",
                 dict(B=4, Sq=256, Skv=256, time_it=True)),
                ("window=256", dict(window=256)),
                ("ragged Sq=1000", dict(Sq=1000, Skv=1000)),
                ("G=8 D=128 Sq=300", dict(Sq=300, Skv=300, H=16, KVH=2,
                                          D=128)),
                ("G=1 D=128 Sq=100 Skv=164 q_offset=[0,64] window=48",
                 dict(Sq=100, Skv=164, H=4, KVH=4, D=128, offs=(0, 64),
                      window=48)),
                # whisper-small without the causal mask (phase 13): the
                # encoder (1500 frames, ragged against the 64-token
                # tiles) and the cross prefill (the prompt x the frames)
                ("whisper encoder non-causal B8 Sq=Skv=1500 H=KVH=12",
                 dict(B=8, Sq=1500, Skv=1500, H=12, KVH=12, causal=False,
                      time_it=True)),
                ("whisper cross prefill non-causal B8 Sq=416 Skv=1500 "
                 "H=KVH=12", dict(B=8, Sq=416, Skv=1500, H=12, KVH=12,
                                  causal=False, time_it=True))):
            r = check_flash(dtype, **kw)
            cases.append(("flash_attention", tag, name, r))
            if tag == "fp32" and name == "main Sq=1024":
                main["flash_attention"] = r
            if tag == "fp32" and name.startswith("whisper encoder"):
                main["flash_attention encoder"] = r
            if tag == "fp32" and name.startswith("whisper cross"):
                main["flash_attention cross"] = r
        # the model zoo's head layouts at D 128 (phase 9's paths)
        for name, kw in ZOO_PAGED:
            r = check_paged(rng, dtype, D=128, n_splits=4, time_it=True,
                            **kw)
            cases.append(("paged_attention", tag, name, r))
        for name, kw in SHARD_PAGED:
            r = check_paged(rng, dtype, time_it=True, **kw)
            cases.append(("paged_attention", tag, name, r))
            _free()
        for name, kw in ZOO_FLASH:
            r = check_flash(dtype, D=128, time_it=True, **kw)
            cases.append(("flash_attention", tag, name, r))
        for name, kw in SSM_SHAPES + (
                ("zamba2 prefill, 32 P columns a block",
                 dict(p_slice=32)),
                ("slot prefill, 64 P columns a block",
                 dict(B=1, p_slice=64)),
                ("valid_len tail S=1024 chunk=128", dict(masked=True)),
                ("valid_len tail S=7 chunk=1",
                 dict(S=7, chunk=1, masked=True)),
                ("chunk 100 S=200 N=P=128 H=8",
                 dict(S=200, chunk=100, H=8, N=128, P=128, masked=True)),
                # ROADMAP C.6: a prime slot prompt, as the scan ran it
                # before (chunk 1: the step kernel over every token) and as
                # models/ssm.py pads it now (to S 1056, chunk 96, the tail
                # as identity steps)
                ("slot prefill B=1 S=1031 chunk=1 (prime, unpadded)",
                 dict(B=1, S=1031, chunk=1)),
                ("slot prefill B=1 S=1056 chunk=96 valid 1031 (padded)",
                 dict(B=1, S=1056, chunk=96, masked=1031))):
            r = check_ssm(dtype, time_it=("valid_len" not in name
                                          and "N=P" not in name), **kw)
            cases.append(("ssm_scan", tag, name, r))
            if tag == "fp32" and name.startswith("zamba2 prefill B"):
                main["ssm_scan"] = r
            if tag == "fp32" and name.startswith("zamba2 decode"):
                main["ssm_scan_decode"] = r
    bad = []
    for kern, tag, name, r in cases:
        line = (f"[kernels] {kern} {tag} {name}: max_abs_err="
                f"{r['max_abs_err']:.3e}")
        if "max_rel_err" in r:
            line += f" max_rel_err={r['max_rel_err']:.3e}"
        line += " ok" if r["ok"] else " FAIL"
        if "ms" in r:
            line += (f" ms={r['ms']:.4f}"
                     + (f" (graph replay {r['graph_ms']:.4f})"
                        if "graph_ms" in r else "")
                     + f" bound_ms={r['bound_ms']:.4f} "
                     f"({r['bound_by']}"
                     + (f"; at 67 TF/s {r['bound_ms_cuda_cores']:.4f}"
                        if "bound_ms_cuda_cores" in r else "")
                     + f") plain_ms={r['plain_ms']:.4f} "
                     f"library_ms={r.get('library_ms', 'none')}"
                     + (f" ({r['library']})" if "library" in r else ""))
            if "library_err" in r:
                line += (" (library: scaled_dot_product_attention"
                         + (", merged output" if kern == "flash_decode"
                            else "")
                         + f"; its max_abs_err {r['library_err']:.3e})")
        if "dead_splits" in r:
            line += f" dead_blocks={r['dead_splits']}"
        print(line, flush=True)
        if not r["ok"]:
            bad.append(f"{kern} {tag} {name}")
    status = {k: ("fail" if any(b.startswith(k) for b in bad) else "ok")
              for k in ("paged_attention", "flash_attention", "flash_decode",
                        "ssm_scan")}
    print("[kernels] " + json.dumps({k: {
        "status": status[k], "max_abs_err": max(
            r["max_abs_err"] for kk, t, _, r in cases
            if kk == k and t == "fp32"),
        "max_abs_err_bf16": max(r["max_abs_err"] for kk, t, _, r in cases
                                if kk == k and t == "bf16"),
        "launches": ("counted on the bench and whisper runs below"
                     if k == "flash_decode"
                     else "counted on the engine run below")}
        for k in status}), flush=True)
    if bad:
        fail("kernels disagree with their plain versions: " + ", ".join(bad))
    return main


# ---------------------------------------------------------------------------
# 4. the kernel bench entry point
# ---------------------------------------------------------------------------

def phase_bench(smi: str) -> dict:
    """``repro_torch.launch.kernel_bench`` at full size on the card: its
    asserts must hold (it raises otherwise), its JSON must carry the JAX
    bench's keys, and each kernel's launches must equal the calls the
    bench made of its wrapper. Returns the launch counts."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.launch import kernel_bench
    fns = dict(_kernel_fns(), flash_decode=flash_decode)
    path = HERE / "build" / "kernel_bench.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for fn in fns.values():
        fn.launches = 0
    out = kernel_bench.main(["--json", str(path)])
    la = {k: fn.launches for k, fn in fns.items()}
    dt = time.perf_counter() - t0
    doc = json.loads(path.read_text())
    if sorted(doc) != ["bench", "decode_step", "maxerr", "rows"]:
        fail(f"kernel_bench JSON keys {sorted(doc)}")
    want = dict(out["calls"], flash_attention=0)
    print(f"[bench] kernel_bench: {len(doc['rows'])} rows in {dt:.1f} s, "
          f"maxerr {doc['maxerr']}, launches " + " ".join(
              f"{k}={la[k]} (calls {want[k]})" for k in la) + f" | {smi}",
          flush=True)
    if la != want or not la["flash_decode"]:
        fail(f"kernel_bench: kernel launches {la} do not match the bench's "
             f"calls {want}")
    return la


# ---------------------------------------------------------------------------
# 5. full-width engine
# ---------------------------------------------------------------------------

def serve(cfg, params, *, mode, horizon, splits, n_req, use_kernels, chunk,
          prompts, max_prefill=64, decode_graphs=None, time_replay=True,
          draft_params=None, n_pages=1024, max_context=1280, sample=None,
          **ecfg_kw):
    from repro_torch.serving import DecodeEngine, EngineConfig, Request
    torch.cuda.reset_peak_memory_stats()
    ecfg = EngineConfig(n_slots=8, page_size=16, n_pages=n_pages,
                        max_context=max_context, eos_token=-1,
                        prefill_mode=mode,
                        prefill_chunk=chunk, decode_horizon=horizon,
                        kernel_splits=splits, use_kernels=use_kernels,
                        max_prefill=max_prefill, decode_graphs=decode_graphs,
                        **ecfg_kw)
    eng = DecodeEngine(cfg, ecfg, params, device=DEV,
                       draft_params=draft_params, sample=sample)
    for i, p in enumerate(prompts[:n_req]):
        eng.submit(Request(i, p, 32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run(100_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.batcher.stats
    bal = eng.alloc.shard_balance()
    tm = eng.timing
    ttft = [eng.first_tok_t[r] - eng.submit_t[r] for r in out]
    m = {"completed": st.completed, "n": n_req,
         "bal_max": int(bal.max()), "bal_min": int(bal.min()),
         "tokens": sum(len(v) for v in out.values()), "wall_s": wall,
         "ttft_mean_ms": 1e3 * float(np.mean(ttft)),
         "ttft_max_ms": 1e3 * float(np.max(ttft)),
         "decode_steps": tm.decode_steps, "prefill_calls": tm.prefill_calls,
         "encoder_calls": tm.encoder_calls,
         "decode_tokens": tm.decode_tokens, "device_syncs": tm.device_syncs,
         "sample_readbacks": tm.sample_readbacks,
         "decode_s": tm.decode_s, "prefill_s": tm.prefill_s,
         "graphs": eng.horizons.graphs, "graph_captures": tm.graph_captures,
         "capture_s": tm.capture_s, "keys": sorted(eng.horizons.captured),
         "replay_step_ms": (replay_step_ms(eng) if eng.horizons.graphs
                            and time_replay and not eng.spec else None),
         "spec": eng.spec, "draft_catchups": tm.draft_catchups,
         "spec_dispatches": dict(tm.spec_dispatches),
         "pages_in_use": eng.alloc.pages_in_use,
         "preempted": st.preempted, "rstate_restores": eng.rstate_restores,
         "rsnaps_left": len(eng.rsnaps),
         "peak_bytes": torch.cuda.max_memory_allocated()}
    if eng.spec:
        m.update(spec_rounds=eng.spec_rounds,
                 spec_proposed=eng.spec_proposed,
                 spec_accepted=eng.spec_accepted,
                 draft_layers=eng.draft_cfg.n_layers,
                 draft_grp=eng.draft_cfg.n_heads // eng.draft_cfg.n_kv_heads)
        if eng.horizons.graphs and time_replay:
            m.update(spec_round_ms(eng))
    # the engine (and its graphs and their memory pool) goes here; the
    # prefiller refers back to it, so the cycle needs the collector
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {k: list(v) for k, v in out.items()}, m


def replay_step_ms(eng, reps: int = 10) -> float:
    """Device time of one decode step on the graph path, after a run: the
    widest captured horizon replayed ``reps`` times with ``allow`` zeroed
    (no slot runs: the same kernels at the same shapes, KV writes to the
    trash page, every slot's state kept), by CUDA events, over its K steps.
    The slot table is as the run left it (slots freed before its last
    horizon hold no context), so K1's share may fall below a served
    step's. The graph is replayed directly, so the launch counters stay as
    the run left them."""
    key = max(eng.horizons.captured)
    graph = eng.horizons.captured[key].graph
    eng.horizons.allow.zero_()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * key[1])


def _replay_ms(graph, reps: int = 10) -> float:
    """Device time of one replay of ``graph`` by CUDA events."""
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def spec_round_ms(eng) -> dict:
    """Device time of a speculative round and of its draft part, after a
    run: the widest captured round replayed with ``allow`` zeroed (every
    kernel at its shape, no slot advanced: see ``replay_step_ms``), and
    the draft's proposal scan alone captured the same way and replayed.
    The launch counters and the generators end as they were."""
    from repro_torch.models import model as MDL
    from repro_torch.serving import graphs as GR
    runner, E = eng.horizons, eng.ecfg
    key = max(k for k in runner.captured if k[2])
    width, K, _ = key
    runner.allow.zero_()
    round_ms = _replay_ms(runner.captured[key].graph)
    counts = GR.launch_counts()
    states = [g.get_state() for g in eng.generators]

    def draft():
        MDL.draft_propose(
            eng.draft_cfg, eng.draft_params, eng._dstate, eng.dev.tokens,
            eng.dev.bt, eng.dev.ctx, runner.allow, eng.dgen,
            horizon=K - 1, table_width=width, page_size=E.page_size,
            n_pages=E.n_pages, sample=eng._scan_sample, need_q=eng.need_q,
            rt=eng.rt)
    graph = torch.cuda.CUDAGraph()
    for g in eng.generators:
        graph.register_generator_state(g)
    runner._warmup(draft)
    with torch.cuda.graph(graph, pool=runner.pool):
        draft()
    draft_ms = _replay_ms(graph)
    del graph
    GR._set_counts(counts)
    for g, st in zip(eng.generators, states):
        g.set_state(st)
    return {"round_key": key, "round_ms": round_ms, "draft_ms": draft_ms}


def _kernel_fns():
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.paged_attention import paged_attention_partials
    from repro_torch.kernels.ssm_scan import ssm_chunk_scan
    return {"paged_attention": paged_attention_partials,
            "flash_attention": flash_attention_fwd,
            "flash_decode": flash_decode,
            "ssm_scan": ssm_chunk_scan}


def expected_launches(cfg, m) -> dict:
    """Launches the main path implies: one paged-decode launch per attention
    layer (global or windowed alike: a layer's window rides in its launch)
    and decode step, one flash launch per attention layer and prefill call,
    one scan launch per Mamba2 layer and call of either; a MoE layer's
    routing and expert products launch none of the port's kernels (PyTorch
    products, as repro's are einsums outside any Pallas kernel). A
    speculative run (``m["spec"]``), per round of K: the draft's K - 1
    decode steps (one paged launch per draft layer each) and the verify
    pass (per target layer, one paged launch per tile of the G * K query
    rows: ``row_tiles``); plus one flash launch per draft layer and
    catch-up call. Its decode steps outside rounds (the degradation ladder
    turned spec off) launch as plain steps. The enc-dec family adds, per
    decoder layer, one flash-decode launch (the cross-attention) a decode
    step and one non-causal flash launch (the cross prefill) a prefill
    call, and one non-causal flash launch per encoder layer and encoder
    pass (``m["encoder_calls"]``)."""
    from repro_torch.kernels.paged_attention import row_tiles
    kinds = cfg.block_kinds()
    n_attn = sum(1 for k in kinds if k in ("attn", "local"))
    n_mamba = sum(1 for k in kinds if k == "mamba")
    n_cross = cfg.n_layers if cfg.family == "encdec" else 0
    noncausal = (n_cross * m["prefill_calls"]
                 + cfg.enc_layers * m.get("encoder_calls", 0))
    want = {"paged_attention": n_attn * m["decode_steps"],
            "flash_attention": n_attn * m["prefill_calls"] + noncausal,
            "flash_attention noncausal": noncausal,
            "flash_decode": n_cross * m["decode_steps"],
            "ssm_scan": n_mamba * (m["decode_steps"] + m["prefill_calls"]),
            "ssm_scan chunk": n_mamba * m["prefill_calls"],
            "ssm_scan step": n_mamba * m["decode_steps"]}
    if m.get("spec"):
        grp = cfg.n_heads // cfg.n_kv_heads
        dl, dgrp = m["draft_layers"], m["draft_grp"]
        rounds = m["spec_dispatches"].items()
        want["paged_attention"] = n_attn * (
            m["decode_steps"] - sum(K * n for K, n in rounds)) + sum(
            n * (n_attn * len(row_tiles(grp * K))
                 + dl * (K - 1) * len(row_tiles(dgrp)))
            for K, n in rounds)
        want["flash_attention"] += dl * m["draft_catchups"]
    return want


def launch_counts(fns) -> dict:
    """Each wrapper's launch count, K2's non-causal launches apart, and
    K4's by route (its chunk kernel carries prefill, its step kernel the
    decode step)."""
    la = {k: fn.launches for k, fn in fns.items()}
    la["flash_attention noncausal"] = fns["flash_attention"] \
        .launches_noncausal
    la["ssm_scan chunk"] = fns["ssm_scan"].launches_chunk
    la["ssm_scan step"] = fns["ssm_scan"].launches_step
    return la


def reset_counts(fns) -> None:
    for fn in fns.values():
        fn.launches = 0
    fns["paged_attention"].launches_windowed = 0
    fns["flash_attention"].launches_noncausal = 0
    fns["ssm_scan"].launches_chunk = fns["ssm_scan"].launches_step = 0


def near_tie_gap(cfg, params, seq) -> float:
    """Top-1 minus top-2 logit of the plain-path model after ``seq``."""
    from repro_torch.core.paged_kv import PoolSpec
    from repro_torch.models import model as MDL
    from repro_torch.kernels.backend import KernelConfig
    n_attn = sum(1 for k in cfg.block_kinds() if k in ("attn", "local"))
    W = -(-len(seq) // 16)
    spec = PoolSpec(max(n_attn, 1), W, 16, cfg.n_kv_heads, cfg.d_head, W,
                    dtype="float32")
    state = MDL.init_decode_state(cfg, spec, 1, device=DEV)
    tok = torch.tensor(np.asarray(seq, np.int32)[None], device=DEV)
    bt = torch.arange(W, dtype=torch.int32, device=DEV)[None]
    frames = (MDL.stub_frames(cfg, 1, DEV) if cfg.family == "encdec"
              else None)
    logits, _ = MDL.prefill(cfg, params, state, tok, bt, frames=frames,
                            rt=MDL.Runtime(kernels=KernelConfig(
                                use_kernels=False)))
    top = logits[0, :cfg.vocab_size].topk(2).values
    return float(top[0] - top[1])


def compare_tokens(label, cfg, params, prompts, out_a, out_b,
                   names, diagnose=None) -> None:
    """Greedy tokens of two engines must agree; a first divergence whose
    plain-path logit gap is below ``TIE_GAP`` is a near tie (ROADMAP C.3)
    and is printed, anything else fails. ``diagnose()`` runs once when a
    request diverges (phase 9: where a MoE's routing first differs)."""
    if diagnose is not None and out_a != out_b:
        diagnose()
    faults = []
    for r in sorted(out_a):
        a, b = out_a[r], out_b[r]
        if a == b:
            continue
        t = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        gap = near_tie_gap(cfg, params, list(prompts[r]) + b[:t])
        print(f"[engine] {label}: request {r} diverges at step {t} "
              f"({names[0]} {a[t:t + 1]} vs {names[1]} {b[t:t + 1]}), "
              f"plain-path logit gap {gap:.3e}"
              + (" - a near tie" if gap < TIE_GAP else " - a fault"),
              flush=True)
        if gap >= TIE_GAP:
            faults.append(r)
    if faults:
        fail(f"{label}: greedy tokens differ between the {names[0]} and "
             f"{names[1]} engines for requests {faults}")
    print(f"[engine] {label}: greedy tokens identical ({names[0]} vs "
          f"{names[1]}) for {sum(out_a[r] == out_b[r] for r in out_a)}/"
          f"{len(out_a)} requests", flush=True)


# the three ways phase 5 serves each configuration: the decode horizon as
# CUDA graphs (the default), dispatched eagerly, and the plain paths
WAYS = (("graphs", dict(use_kernels=None)),
        ("eager", dict(use_kernels=None, decode_graphs=False)),
        ("plain", dict(use_kernels=False)))


def run_arch(arch: str, smi: str, launches: dict, ref: dict | None = None,
             **serve_kw) -> None:
    """Serve ``arch`` at full width in batched and chunked prefill, each
    three ways (``WAYS``), then profile the batched configuration on the
    graph path. ``ref[arch]`` gets the batched graph run's metrics."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, param_count_actual
    cfg = replace(get_config(arch), dtype="float32")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.float32, device=DEV)
    torch.cuda.synchronize()
    n = param_count_actual(params)
    print(f"[engine] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_head={cfg.d_head} "
          f"vocab={cfg.vocab_size} params={n} fp32 "
          f"({4 * n / 2**30:.2f} GiB) init {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n_tok))
               for n_tok in rng.integers(256, 1025, 8)]
    fns = _kernel_fns()
    # first use of each matmul shape, allocator growth: paid here, unreported
    serve(cfg, params, use_kernels=None, prompts=prompts, mode="batched",
          horizon=4, splits=4, n_req=2, chunk=32, **serve_kw)
    for label, kw in (("batched", dict(mode="batched", horizon=4, splits=4,
                                       n_req=8, chunk=32)),
                      ("chunked", dict(mode="chunked", horizon=1, splits=4,
                                       n_req=4, chunk=128))):
        label = f"{arch} {label}"
        outs, ms, las = {}, {}, {}
        for way, wkw in WAYS:
            # the counts are set to 0 just before each run and read just
            # after it; the graph run is the main path's
            reset_counts(fns)
            outs[way], ms[way] = serve(cfg, params, prompts=prompts, **kw,
                                       **wkw, **serve_kw)
            las[way] = launch_counts(fns)
        for way, m in ms.items():
            dec = m["decode_tokens"]
            print(f"[engine] {label} {way}: completed={m['completed']}/"
                  f"{m['n']} page balance max={m['bal_max']} "
                  f"min={m['bal_min']} tokens={m['tokens']} "
                  f"wall={m['wall_s']:.3f} s "
                  f"tok/s={m['tokens'] / m['wall_s']:.1f} "
                  f"decode tok/s={dec / max(m['decode_s'], 1e-9):.1f} "
                  f"ttft mean/max={m['ttft_mean_ms']:.1f}/"
                  f"{m['ttft_max_ms']:.1f} ms decode step "
                  f"ms={1e3 * m['decode_s'] / max(1, m['decode_steps']):.2f}"
                  f" syncs/token={m['device_syncs'] / max(1, dec):.4f} "
                  f"graph captures={m['graph_captures']} (width, K, spec) "
                  f"{m['keys']} capture ms={1e3 * m['capture_s']:.1f} "
                  + (f"replay device ms/step={m['replay_step_ms']:.3f} "
                     if m["replay_step_ms"] is not None else "")
                  + f"decode_steps={m['decode_steps']} "
                  f"prefill_calls={m['prefill_calls']} | {smi}", flush=True)
        if not ms["graphs"]["graphs"] or ms["eager"]["graphs"]:
            fail(f"{label}: the default engine did not run the horizon as "
                 "graphs, or decode_graphs=False did")
        for way in ("graphs", "eager"):
            want = expected_launches(cfg, ms[way])
            la = las[way]
            print(f"[engine] {label} {way} launches: " + " ".join(
                f"{k}={la[k]} (expected {want[k]})" for k in la)
                + f" for decode steps {ms[way]['decode_steps']}, prefill "
                f"calls {ms[way]['prefill_calls']}", flush=True)
            if la != want or not all(la[k] for k in la if want[k]):
                fail(f"{label} {way}: kernel launches {la} do not match the "
                     f"main path's {want}")
        if any(las["plain"].values()):
            fail(f"{label}: the plain-path engine launched a kernel "
                 f"{las['plain']}")
        compare_tokens(label, cfg, params, prompts, outs["graphs"],
                       outs["eager"], ("graphs", "eager"))
        compare_tokens(label, cfg, params, prompts, outs["graphs"],
                       outs["plain"], ("graphs", "plain"))
        for way, m in ms.items():
            if m["completed"] != m["n"] or m["bal_max"] or m["bal_min"]:
                fail(f"{label} {way}: completed {m['completed']}/{m['n']}, "
                     f"page balance {m['bal_max']}/{m['bal_min']}")
        syncs = {way: m["device_syncs"] for way, m in ms.items()}
        if len(set(syncs.values())) != 1:
            fail(f"{label}: device syncs differ across the ways: {syncs}")
        for k, v in las["graphs"].items():
            launches[k] = launches.get(k, 0) + v
        if ref is not None and label.endswith("batched"):
            ref[arch] = ms["graphs"]
    phase_profile(cfg, params, prompts, smi, serve_kw)
    del params
    torch.cuda.empty_cache()


def phase_engine(smi: str, ref: dict) -> dict:
    launches: dict = {}
    run_arch("llama3.2-1b", smi, launches, ref)
    # pow2 prefill buckets (256/512/1024): the Mamba2 scan runs at chunk
    # 128 in every bucket
    run_arch("zamba2-1.2b", smi, launches, ref, max_prefill=1024)
    return launches


def phase_profile(cfg, params, prompts, smi: str, serve_kw) -> None:
    """Where the time goes: the batched configuration on the graph path
    under torch.profiler — device busy time against wall time, and the
    kernels that take it. The idle share is trusted only once the profiler
    is seen to attribute the kernels that run inside the graphs: K1's
    kernel must show one call per attention layer and decode step replayed
    plus those of the captures' warm-up passes (a capture runs nothing)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, m = serve(cfg, params, use_kernels=None, prompts=prompts,
                     mode="batched", horizon=4, splits=4, n_req=8, chunk=32,
                     time_replay=False, **serve_kw)

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    from torch.autograd import DeviceType
    ka = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not ka:
        print(f"[profile] {cfg.name}: the profiler recorded no device "
              "kernels; device time not measured", flush=True)
        return
    n_attn = sum(1 for k in cfg.block_kinds() if k in ("attn", "local"))
    k1 = sum(e.count for e in ka if "paged_partials_kernel" in e.key)
    want = n_attn * (m["decode_steps"] + sum(K for _, K, _ in m["keys"]))
    seen = k1 == want
    print(f"[profile] {cfg.name}: K1 calls under the profiler {k1}, "
          f"expected {want} = {n_attn} x ({m['decode_steps']} decode steps "
          f"replayed + warm-up steps of captures {m['keys']}): "
          + ("kernels inside the graphs are attributed" if seen else
             "NOT attributed; the idle share below is not measured"),
          flush=True)
    busy = sum(dev_us(e) for e in ka) / 1e3
    wall = 1e3 * m["wall_s"]
    cap = 1e3 * m["capture_s"]
    print(f"[profile] {cfg.name} batched, graph path, under torch.profiler: "
          f"wall={wall:.1f} ms device busy={busy:.1f} ms idle share="
          f"{1 - busy / wall:.3f}; without the {m['graph_captures']} "
          f"captures ({cap:.1f} ms) idle share={1 - busy / (wall - cap):.3f}"
          f" (prefill {1e3 * m['prefill_s']:.1f} ms, decode "
          f"{1e3 * m['decode_s']:.1f} ms over {m['decode_steps']} steps)"
          f"{'' if seen else ' [not measured: attribution failed]'} | {smi}",
          flush=True)
    for e in sorted(ka, key=dev_us, reverse=True)[:12]:
        print(f"[profile] {cfg.name} {dev_us(e) / 1e3:9.3f} ms "
              f"{e.count:6d} calls {e.key[:90]}")
    sys.stdout.flush()


# ---------------------------------------------------------------------------
# 7. the KV-cache hierarchy
# ---------------------------------------------------------------------------

def shared_prompts(vocab: int, n: int, lo: int, hi: int, frac: float,
                   max_context: int, seed: int = 0) -> list:
    """Prompts as ``launch/serve.py --shared-frac`` builds them: a common
    system prompt of ``max_context`` random ids opens every prompt over
    ``frac`` of its length (at least one private token); lengths uniform in
    [lo, hi]."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, size=max_context)
    out = []
    for n_tok in rng.integers(lo, hi + 1, n):
        prompt = rng.integers(0, vocab, size=int(n_tok))
        k = min(int(n_tok * frac), int(n_tok) - 1)
        prompt[:k] = system[:k]
        out.append(prompt)
    return out


def kv_engine(cfg, params, *, device=DEV, n_pages=1024, **ecfg_kw):
    """The engine phases 7 and 10 serve on (its default path: graphs on a
    card): 8 slots, 16-token pages, a 1280-token context, no EOS."""
    from repro_torch.serving import DecodeEngine, EngineConfig
    ecfg = EngineConfig(n_slots=8, page_size=16, n_pages=n_pages,
                        max_context=1280, eos_token=-1, **ecfg_kw)
    return DecodeEngine(cfg, ecfg, params, device=device)


def serve_kv(cfg, params, prompts, *, device=DEV, new=32, eng=None,
             sample=None, keep=False, **engine_kw):
    """Serve ``prompts`` tick by tick on ``eng`` (by default a new
    ``kv_engine(**engine_kw)``) until it drains, calling ``sample(eng)``
    after every tick, and return (outputs, measures): TTFT by whether
    admission hit the prefix cache (``matched``: each request's first
    admission's matched tokens), the peak of pages in use, the cache and
    tier counters, the copies' bytes and device ms, and whether the pool
    kept its tensors. ``keep`` returns the engine as ``measures["engine"]``
    instead of freeing it."""
    from repro_torch.serving import Request
    if eng is None:
        eng = kv_engine(cfg, params, device=device, **engine_kw)
    matched: dict[int, int] = {}
    if eng.cache is not None:
        lookup = eng.cache.lookup

        def record(req_id, tokens):
            hit = lookup(req_id, tokens)
            matched.setdefault(req_id, hit.matched)   # first admission
            return hit
        eng.cache.lookup = record
    pool = eng.state.get("pool")
    ptrs = {k: t.data_ptr() for k, t in pool.items()} if pool else {}
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, new))
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    peak = ticks = 0
    while not (eng._inflight is None and eng.batcher.done()):
        eng.tick()
        if sample is not None:
            sample(eng)
        peak = max(peak, eng.alloc.pages_in_use)
        ticks += 1
        if ticks > 100_000:
            fail(f"{cfg.name}: serving did not finish")
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = {k: list(v) for k, v in eng.outputs.items()}
    ttft = {r: eng.first_tok_t[r] - eng.submit_t[r] for r in out
            if r in eng.first_tok_t and r in eng.submit_t}
    hit = [1e3 * ttft[r] for r in ttft if matched.get(r, 0) > 0]
    cold = [1e3 * ttft[r] for r in ttft if matched.get(r, 0) == 0]
    tm, st = eng.timing, eng.batcher.stats
    m = {"completed": st.completed, "n": len(prompts), "wall_s": wall,
         "preempted": st.preempted, "peak_pages": peak,
         "pages_in_use": eng.alloc.pages_in_use,
         "ttft_hit_ms": float(np.mean(hit)) if hit else None,
         "ttft_cold_ms": float(np.mean(cold)) if cold else None,
         "n_hit": len(hit), "n_cold": len(cold), "matched": matched,
         "ttft_mean_ms": 1e3 * float(np.mean(list(ttft.values())))
         if ttft else None,
         "decode_steps": tm.decode_steps, "prefill_calls": tm.prefill_calls,
         "decode_s": tm.decode_s, "prefill_s": tm.prefill_s,
         "device_syncs": tm.device_syncs, "graphs": eng.horizons.graphs,
         "graph_captures": tm.graph_captures,
         "ptrs_kept": bool(pool) and ptrs == {
             k: t.data_ptr() for k, t in eng.state["pool"].items()},
         "rstate_snapshots": eng.rstate_snapshots,
         "rstate_restores": eng.rstate_restores,
         "rsnaps_left": len(eng.rsnaps), "cache": None, "tier": None,
         "copy": None, "tree_pages": 0,
         "page_bytes": eng.pool_spec.bytes(4) // eng.pool_spec.n_pages}
    if eng.cache is not None:
        m["cache"] = eng.cache.stats.as_dict()
        m["tree_pages"] = eng.cache.tree.device_pages()
        if eng.cache.host is not None:
            eng.cache.host.copier.settle()
            m["tier"] = eng.cache.host.stats.as_dict()
            m["copy"] = eng.cache.host.copier.stats.as_dict()
    if keep:
        m["engine"] = eng
        return out, m
    del eng
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    return out, m


def _gbs(nbytes: int, ms: float) -> str:
    return f"{nbytes / 1e6 / ms:.2f} GB/s" if ms > 0 else "not measured"


def kv_line(label: str, m: dict, smi: str) -> str:
    def ms(x):
        return "-" if x is None else f"{x:.1f}"
    line = (f"[kvcache] {label}: completed={m['completed']}/{m['n']} "
            f"preempted={m['preempted']} peak pages={m['peak_pages']} "
            f"ttft mean={m['ttft_mean_ms']:.1f} ms, hit {ms(m['ttft_hit_ms'])}"
            f" ms ({m['n_hit']} requests) / cold {ms(m['ttft_cold_ms'])} ms "
            f"({m['n_cold']}) decode step ms="
            f"{1e3 * m['decode_s'] / max(1, m['decode_steps']):.2f} "
            f"prefill calls={m['prefill_calls']} prefill "
            f"s={m['prefill_s']:.3f} wall={m['wall_s']:.3f} s "
            f"syncs={m['device_syncs']} captures={m['graph_captures']}")
    if m["cache"] is not None:
        c = m["cache"]
        line += (f" | hits={c['hits']}/{c['lookups']} hit_tokens="
                 f"{c['hit_tokens']} cow={c['cow_copies']} evicted="
                 f"{c['evicted_pages']} tree pages={m['tree_pages']}")
    if m["tier"] is not None:
        t, cp = m["tier"], m["copy"]
        prefix58 = 58 * m["page_bytes"] * cp["h2d_ms"] / max(1,
                                                             cp["h2d_bytes"])
        line += (f" | swap out {t['swapped_out_pages']} pages "
                 f"{cp['d2h_bytes']} B {cp['d2h_ms']:.3f} ms "
                 f"{_gbs(cp['d2h_bytes'], cp['d2h_ms'])}, in "
                 f"{t['swapped_in_pages']} pages {cp['h2d_bytes']} B "
                 f"{cp['h2d_ms']:.3f} ms {_gbs(cp['h2d_bytes'], cp['h2d_ms'])}"
                 f" (swap-ins and host copies on write; a 58-page prefix "
                 f"at this rate: {prefix58:.3f} ms), peak host pages "
                 f"{t['peak_host_pages']}, pinned allocation "
                 f"{cp['pin_alloc_ms']:.1f} ms of host time")
    if m["rstate_snapshots"] or m["rstate_restores"]:
        line += (f" | rstate snapshots={m['rstate_snapshots']} restores="
                 f"{m['rstate_restores']}")
    return line + f" | {smi}"


def kv_llama(cfg, params, smi: str, launches: dict, *, device=DEV,
             n_req: int = 16) -> dict:
    """llama3.2-1b: a 0.9-shared trace served (a) without the cache on an
    ample pool, (b) with it on the same pool in batched and chunked
    prefill, (c) with it on a pool of ~40% of (a)'s peak pages and a host
    tier for the rest (watermark offload and swap-in). Returns the
    measures by label."""
    prompts = shared_prompts(cfg.vocab_size, n_req, 512, 1024, 0.9, 1280)
    fns = _kernel_fns()
    batched = dict(prefill_mode="batched", decode_horizon=4,
                   kernel_splits=4)
    chunked = dict(prefill_mode="chunked", prefill_chunk=128,
                   decode_horizon=1, kernel_splits=4)
    runs = {}

    def run(label, **kw):
        reset_counts(fns)
        out, m = serve_kv(cfg, params, prompts, device=device, **kw)
        la = launch_counts(fns)
        runs[label] = out, m
        print(kv_line(f"{cfg.name} {label}", m, smi), flush=True)
        if device == "cpu":
            return out, m
        want = expected_launches(cfg, m)
        print(f"[kvcache] {cfg.name} {label} launches: " + " ".join(
            f"{k}={la[k]} (expected {want[k]})" for k in la), flush=True)
        if la != want or not all(la[k] for k in la if want[k]):
            fail(f"{label}: kernel launches {la} do not match {want}")
        if not m["graphs"]:
            fail(f"{label}: the engine did not run the horizon as graphs")
        for k, v in la.items():
            launches[k] = launches.get(k, 0) + v
        return out, m

    ref, ma = run("(a) cache off, ample pool", **batched)
    tight = max(16, int(0.4 * ma["peak_pages"]))
    run("(b) prefix cache, ample pool, batched", prefix_cache=True,
        **batched)
    run("(b) prefix cache, ample pool, chunked", prefix_cache=True,
        **chunked)
    run(f"(c) prefix cache, {tight}-page pool, host tier", n_pages=tight,
        prefix_cache=True, host_pages=ma["peak_pages"],
        prefill_dedup=False, **batched)
    for label, (out, m) in runs.items():
        if m["completed"] != m["n"]:
            fail(f"{label}: completed {m['completed']}/{m['n']}")
        if not m["ptrs_kept"]:
            fail(f"{label}: the pool was rebound")
        if m["pages_in_use"] != m["tree_pages"]:
            fail(f"{label}: {m['pages_in_use']} pages in use, "
                 f"{m['tree_pages']} held by the tree")
        if m["cache"] is not None:
            c = m["cache"]
            if not (c["hits"] > 0 and c["cow_copies"] > 0):
                fail(f"{label}: no hits or no copies on write: {c}")
        if m["tier"] is not None:
            t = m["tier"]
            if not (t["swapped_out_pages"] > 0 and t["swapped_in_pages"] > 0):
                fail(f"{label}: the host tier did not swap both ways: {t}")
        if out is not ref:
            compare_tokens(f"{cfg.name} {label}", cfg, params, prompts,
                           ref, out, ("cache off", "cache on"))
    return {label: m for label, (_, m) in runs.items()}


def kv_zamba(cfg, params, smi: str, launches: dict, *, device=DEV,
             n_req: int = 8, tight: int = 120) -> dict:
    """zamba2-1.2b: preemption snapshots. Each prefill mode on an ample
    pool, then on a ``tight``-page pool with ``state_resume`` on (the
    default: the carry rows and KV pages go to pinned host memory and
    come back) and off (recompute)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n_tok))
               for n_tok in rng.integers(256, 1025, n_req)]
    fns = _kernel_fns()
    out_m = {}
    for mode, kw in (("batched", dict(prefill_mode="batched",
                                      decode_horizon=4)),
                     ("chunked", dict(prefill_mode="chunked",
                                      prefill_chunk=128, decode_horizon=1))):
        runs = {}
        for label, extra in (("ample pool", dict(n_pages=1024)),
                             ("state_resume", dict(n_pages=tight)),
                             ("recompute", dict(n_pages=tight,
                                                state_resume=False))):
            reset_counts(fns)
            out, m = serve_kv(cfg, params, prompts, device=device,
                              max_prefill=1024, kernel_splits=4, **kw,
                              **extra)
            la = launch_counts(fns)
            name = f"{cfg.name} {mode} {label}"
            print(kv_line(name, m, smi), flush=True)
            runs[label] = out, m
            out_m[f"{mode} {label}"] = m
            if m["completed"] != m["n"] or m["pages_in_use"]:
                fail(f"{name}: completed {m['completed']}/{m['n']}, "
                     f"{m['pages_in_use']} pages left")
            if not m["ptrs_kept"] or m["rsnaps_left"]:
                fail(f"{name}: pool rebound or snapshots left")
            if device == "cpu":
                continue
            want = expected_launches(cfg, m)
            print(f"[kvcache] {name} launches: " + " ".join(
                f"{k}={la[k]} (expected {want[k]})" for k in la), flush=True)
            if la != want or not all(la[k] for k in la if want[k]):
                fail(f"{name}: kernel launches {la} do not match {want}")
            for k, v in la.items():
                launches[k] = launches.get(k, 0) + v
        on, off = runs["state_resume"][1], runs["recompute"][1]
        if not (on["preempted"] > 0 and on["rstate_restores"] > 0):
            fail(f"{cfg.name} {mode}: no preemption restored ({on})")
        if off["rstate_restores"] or not off["preempted"]:
            fail(f"{cfg.name} {mode}: the recompute run restored or never "
                 "preempted")
        ref = runs["ample pool"][0]
        for label in ("state_resume", "recompute"):
            compare_tokens(f"{cfg.name} {mode} {label}", cfg, params,
                           prompts, ref, runs[label][0],
                           ("ample pool", label))
    return out_m


def phase_kvcache(smi: str, launches: dict) -> None:
    """Phase 7: the KV-cache hierarchy at full width on the graph path."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    for arch, fn in (("llama3.2-1b", kv_llama), ("zamba2-1.2b", kv_zamba)):
        cfg = replace(get_config(arch), dtype="float32")
        params = init_params(cfg, seed=0, dtype=torch.float32, device=DEV)
        fn(cfg, params, smi, launches)
        del params
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 8. speculative decoding and stochastic sampling
# ---------------------------------------------------------------------------

def spec_line(label: str, m: dict, smi: str, ref: dict | None = None) -> str:
    dec = m["decode_tokens"]
    tok_s = dec / max(m["decode_s"], 1e-9)
    line = (f"[spec] {label}: completed={m['completed']}/{m['n']} "
            f"pages left={m['pages_in_use']} tokens={m['tokens']} "
            f"decode tok/s={tok_s:.1f}")
    if ref is not None:
        ref_s = ref["decode_tokens"] / max(ref["decode_s"], 1e-9)
        line += f" ({tok_s / ref_s:.3f}x the target alone's {ref_s:.1f})"
    line += (f" syncs/token={m['device_syncs'] / max(1, dec):.4f} "
             f"decode s={m['decode_s']:.3f} ttft mean={m['ttft_mean_ms']:.1f}"
             f" ms graph captures={m['graph_captures']} (width, K, spec) "
             f"{m['keys']} capture ms={1e3 * m['capture_s']:.1f}")
    if m["spec"]:
        mean = 1 + m["spec_accepted"] / max(1, m["spec_rounds"])
        line += (f" | rounds={m['spec_rounds']} accepted="
                 f"{m['spec_accepted']}/{m['spec_proposed']} mean accept "
                 f"length={mean:.3f}"
                 f" catch-ups={m['draft_catchups']} rounds by K="
                 f"{m['spec_dispatches']}")
        if "round_ms" in m:
            line += (f" round device ms={m['round_ms']:.3f} (K="
                     f"{m['round_key'][1]}, replayed, no slot running), "
                     f"draft {m['draft_ms']:.3f} ms: draft share "
                     f"{m['draft_ms'] / m['round_ms']:.3f}")
    return line + f" | {smi}"


def phase_spec(smi: str, launches: dict) -> None:
    """Phase 8: speculative decoding and stochastic sampling at full width.

    llama3.2-1b (16 layers, random fp32 weights from seed 0), 8 prompts of
    256-1024 tokens, 32 new tokens, batched prefill, 8 slots, page 16:
    (a) the zeroed-layer oracle target alone, as graphs, at horizon
    spec_horizon + 1 (the reference); (b) the oracle pair
    (``models.convert.oracle_draft_pair``) at spec_horizon 4 and 15, as
    graphs and eagerly: tokens equal (a)'s (the near-tie rule of phase 5),
    counters equal between graphs and eager, acceptance above zero; (c) an
    independent 1-layer draft (seed 7) against the unmodified target
    alone; (d) temperature 0.8 and top-k 8 with the oracle pair, and
    zamba2-1.2b with top-k 8 and no draft, each twice with one seed:
    identical tokens. Every run completes and releases every page, and
    each kernel's launches equal what its rounds, steps and prefill calls
    imply."""
    from repro_torch.configs import get_config
    from repro_torch.models.convert import oracle_draft_pair
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    cfg = replace(get_config("llama3.2-1b"), dtype="float32")
    params = init_params(cfg, seed=0, dtype=torch.float32, device=DEV)
    tparams, dcfg, dparams = oracle_draft_pair(cfg, params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n_tok))
               for n_tok in rng.integers(256, 1025, 8)]
    fns = _kernel_fns()
    base = dict(prompts=prompts, mode="batched", splits=4, n_req=8,
                chunk=32, use_kernels=None)

    def run(label, c, p, **kw):
        reset_counts(fns)
        out, m = serve(c, p, **{**base, **kw})
        la = launch_counts(fns)
        want = expected_launches(c, m)
        print(f"[spec] {label} launches: " + " ".join(
            f"{k}={la[k]} (expected {want[k]})" for k in la if want[k]
            or la[k]), flush=True)
        if la != want or not all(la[k] for k in la if want[k]):
            fail(f"{label}: kernel launches {la} do not match {want}")
        if m["completed"] != m["n"] or m["pages_in_use"] or m["bal_max"] \
                or m["bal_min"]:
            fail(f"{label}: completed {m['completed']}/{m['n']}, "
                 f"{m['pages_in_use']} pages in use")
        if m["graphs"] != (kw.get("decode_graphs") is not False):
            fail(f"{label}: the rounds did not run as asked (graphs "
                 f"{m['graphs']})")
        for k, v in la.items():
            launches[k] = launches.get(k, 0) + v
        return out, m

    spec_kw = dict(draft_params=dparams, draft_config=dcfg, horizon=1)
    for G in (4, 15):
        ref, mr = run(f"(a) oracle target alone, horizon {G + 1}", cfg,
                      tparams, horizon=G + 1)
        print(spec_line(f"llama3.2-1b (a) target alone h{G + 1}", mr, smi),
              flush=True)
        res = {}
        for way, wkw in (("graphs", {}), ("eager",
                                          dict(decode_graphs=False))):
            label = f"(b) oracle pair spec_horizon {G} {way}"
            res[way] = run(label, cfg, tparams, spec_horizon=G, **spec_kw,
                           **wkw)
            print(spec_line(f"llama3.2-1b {label}", res[way][1], smi, mr),
                  flush=True)
            compare_tokens(f"spec {label}", cfg, tparams, prompts, ref,
                           res[way][0], ("target alone", way))
            if not res[way][1]["spec_accepted"]:
                fail(f"{label}: no proposal accepted")
        cnt = ("spec_rounds", "spec_proposed", "spec_accepted",
               "device_syncs", "decode_tokens", "spec_dispatches")
        g, e = res["graphs"][1], res["eager"][1]
        if any(g[k] != e[k] for k in cnt):
            fail(f"spec_horizon {G}: counters differ between graphs and "
                 f"eager: {[(k, g[k], e[k]) for k in cnt]}")
        if g["graph_captures"] < 1 \
                or any(K != G + 1 for _, K, _ in g["keys"]):
            fail(f"spec_horizon {G}: the round was not captured per "
                 f"(width, {G + 1}): {g['keys']}")
    # (c) a draft that rolls back nearly every round
    rparams = init_params(dcfg, seed=7, dtype=torch.float32, device=DEV)
    ref, mr = run("(c) unmodified target alone, horizon 5", cfg, params,
                  horizon=5)
    out, m = run("(c) independent draft spec_horizon 4", cfg, params,
                 spec_horizon=4, **dict(spec_kw, draft_params=rparams))
    print(spec_line("llama3.2-1b (c) independent 1-layer draft (seed 7), "
                    "spec_horizon 4", m, smi, mr), flush=True)
    compare_tokens("spec (c) independent draft", cfg, params, prompts, ref,
                   out, ("target alone", "spec"))
    del rparams
    # (d) stochastic kinds: two runs with one seed give the same tokens
    for sampler in ("temperature", "top_k"):
        outs = [run(f"(d) oracle pair {sampler} run {i}", cfg, tparams,
                    spec_horizon=4, sampler=sampler, temperature=0.8,
                    top_k=8, sample_seed=11, **spec_kw) for i in (1, 2)]
        print(spec_line(f"llama3.2-1b (d) oracle pair {sampler}",
                        outs[0][1], smi), flush=True)
        if outs[0][0] != outs[1][0]:
            fail(f"(d) {sampler}: two runs with one seed differ")
        if not outs[0][1]["spec_accepted"]:
            fail(f"(d) {sampler}: no proposal accepted")
    del params, tparams, dparams
    gc.collect()
    torch.cuda.empty_cache()
    zcfg = replace(get_config("zamba2-1.2b"), dtype="float32")
    zparams = init_params(zcfg, seed=0, dtype=torch.float32, device=DEV)
    zprompts = [rng.integers(0, zcfg.vocab_size, int(n_tok))
                for n_tok in rng.integers(256, 1025, 8)]
    zouts = [run(f"(d) zamba2-1.2b top_k run {i}", zcfg, zparams,
                 prompts=zprompts, horizon=4, max_prefill=1024,
                 sampler="top_k", top_k=8, temperature=0.8, sample_seed=11)
             for i in (1, 2)]
    print(spec_line("zamba2-1.2b (d) top_k 8, no draft, h4", zouts[0][1],
                    smi), flush=True)
    if zouts[0][0] != zouts[1][0]:
        fail("(d) zamba2-1.2b top_k: two runs with one seed differ")
    del zparams
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[spec] phase 8 in {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# 9. the model zoo
# ---------------------------------------------------------------------------

# (arch, layers on the card (None: all), prompt lengths [lo, hi), pool
# pages, max context, prefill bucket cap): qwen1.5-7b whole (the paper's
# Table 1 model), gemma3-27b's first 5:1 local:global cycle with prompts
# past its 1024-token window, phi3.5-moe's first 4 layers
ZOO = (("qwen1.5-7b", None, (256, 1025), 1024, 1280, 1024),
       ("gemma3-27b", 6, (1100, 2049), 1280, 2176, 2048),
       ("phi3.5-moe-42b-a6.6b", 4, (256, 1025), 1024, 1280, 1024))


def first_router_flip(cfg, params, kw) -> None:
    """Where a MoE's routing first differs between the kernel and plain
    paths: both served again eagerly with every routing decision kept (the
    chosen experts, and the gap between the k-th and (k+1)-th router
    probabilities); prints the first call and row whose experts differ and
    the plain path's gap there."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    inner = MOE.route
    recs = {}
    for way, wkw in (("kernels", dict(use_kernels=None)),
                     ("plain", dict(use_kernels=False))):
        rec = []

        def route(router_w, c, x, rec=rec):
            top_p, top_e = inner(router_w, c, x)
            probs = torch.softmax(L.dense(x, router_w).float(), dim=-1)
            srt = probs.sort(dim=-1, descending=True).values
            rec.append((top_e.clone(), srt[:, c.moe_top_k - 1]
                        - srt[:, c.moe_top_k]))
            return top_p, top_e
        MOE.route = route
        try:
            serve(cfg, params, decode_graphs=False, time_replay=False,
                  **kw, **wkw)
        finally:
            MOE.route = inner
        recs[way] = rec
    for i, ((ek, _), (ep, gp)) in enumerate(zip(recs["kernels"],
                                                 recs["plain"])):
        if ek.shape != ep.shape or not torch.equal(ek, ep):
            row = 0 if ek.shape != ep.shape else int(
                (ek != ep).any(dim=1).nonzero()[0, 0])
            print(f"[models] {cfg.name}: routing first differs at call {i} "
                  f"of {len(recs['plain'])} ({ep.shape[0]} rows, layer "
                  f"{i % cfg.n_layers}), row {row}: kernel path experts "
                  f"{ek[row].tolist()}, plain {ep[row].tolist()}, plain-path "
                  f"router gap {float(gp[row]):.3e} (the call's smallest "
                  f"{float(gp.min()):.3e})", flush=True)
            return
    print(f"[models] {cfg.name}: routing identical over "
          f"{len(recs['plain'])} calls", flush=True)


def moe_drops(cfg, params, kw) -> str:
    """A MoE's dropped choices, the plain path served again eagerly with
    each call's drops kept on the device: decode calls route one row a
    slot, prefill calls more."""
    from repro_torch.models import moe as MOE
    inner = MOE._dispatch_indices
    seen = []

    def counting(top_e, E, C):
        slot, keep = inner(top_e, E, C)
        seen.append((top_e.shape[0], top_e.numel(), (~keep).sum()))
        return slot, keep
    MOE._dispatch_indices = counting
    try:
        serve(cfg, params, use_kernels=False, decode_graphs=False,
              time_replay=False, **kw)
    finally:
        MOE._dispatch_indices = inner
    out = []
    for name, rows in (("decode", [r for r in seen if r[0] == 8]),
                       ("prefill", [r for r in seen if r[0] != 8])):
        dropped = int(sum(d for *_, d in rows)) if rows else 0
        out.append(f"{name} {dropped} of {sum(n for _, n, _ in rows)} "
                   f"choices in {len(rows)} calls")
    return "dropped: " + ", ".join(out)


def phase_models(smi: str, launches: dict) -> None:
    """Phase 9: the model zoo at full width (``ZOO``; random fp32 weights
    from seed 0, fp32 pool, page 16, 8 slots). Each configuration serves 8
    requests of 32 new tokens, batched prefill, horizon 4, on the graph
    path and on the plain path: greedy tokens identical (the near-tie rule
    of phase 5; a MoE's divergence also prints where its routing first
    differs), every request complete, every page released, device syncs
    equal, the graph run's launches equal to what its decode steps and
    prefill calls imply and the plain run launching none. Prints decode
    tok/s, TTFT, the replayed decode step and peak device memory, then
    profiles the graph path (phase 6's breakdown)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, param_count_actual
    t0 = time.perf_counter()
    fns = _kernel_fns()
    for arch, layers, (lo, hi), n_pages, max_ctx, cap in ZOO:
        cfg = replace(get_config(arch), dtype="float32")
        if layers:
            cfg = replace(cfg, n_layers=layers)
        t1 = time.perf_counter()
        params = init_params(cfg, seed=0, dtype=torch.float32, device=DEV)
        torch.cuda.synchronize()
        n = param_count_actual(params)
        print(f"[models] {arch}: {cfg.n_layers} of "
              f"{get_config(arch).n_layers} layers d={cfg.d_model} heads="
              f"{cfg.n_heads}/{cfg.n_kv_heads} d_head={cfg.d_head} d_ff="
              f"{cfg.d_ff} vocab={cfg.vocab_size} experts={cfg.n_experts} "
              f"window={cfg.sliding_window} params={n} fp32 "
              f"({4 * n / 1e9:.2f} GB) init "
              f"{time.perf_counter() - t1:.1f} s", flush=True)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, int(n_tok))
                   for n_tok in rng.integers(lo, hi, 8)]
        kw = dict(prompts=prompts, mode="batched", horizon=4, splits=4,
                  n_req=8, chunk=32, max_prefill=cap, n_pages=n_pages,
                  max_context=max_ctx)
        # first use of each matmul shape, allocator growth: unreported
        serve(cfg, params, use_kernels=None, time_replay=False,
              **dict(kw, n_req=2))
        outs, ms, las = {}, {}, {}
        for way, wkw in (("graphs", dict(use_kernels=None)),
                         ("plain", dict(use_kernels=False))):
            reset_counts(fns)
            outs[way], ms[way] = serve(cfg, params, **kw, **wkw)
            las[way] = launch_counts(fns)
        for way, m in ms.items():
            dec = m["decode_tokens"]
            print(f"[models] {arch} {way}: completed={m['completed']}/"
                  f"{m['n']} pages left={m['pages_in_use']} tokens="
                  f"{m['tokens']} decode tok/s="
                  f"{dec / max(m['decode_s'], 1e-9):.1f} ttft mean/max="
                  f"{m['ttft_mean_ms']:.1f}/{m['ttft_max_ms']:.1f} ms "
                  f"prefill s={m['prefill_s']:.3f} decode step ms="
                  f"{1e3 * m['decode_s'] / max(1, m['decode_steps']):.3f} "
                  + (f"replay device ms/step={m['replay_step_ms']:.3f} "
                     if m["replay_step_ms"] is not None else "")
                  + f"syncs/token={m['device_syncs'] / max(1, dec):.4f} "
                  f"graph captures={m['graph_captures']} "
                  f"peak memory={m['peak_bytes'] / 1e9:.2f} GB "
                  f"decode_steps={m['decode_steps']} "
                  f"prefill_calls={m['prefill_calls']} | {smi}", flush=True)
        want = expected_launches(cfg, ms["graphs"])
        la = las["graphs"]
        print(f"[models] {arch} graphs launches: " + " ".join(
            f"{k}={la[k]} (expected {want[k]})" for k in la
            if want[k] or la[k]), flush=True)
        if la != want or not all(la[k] for k in la if want[k]):
            fail(f"{arch}: kernel launches {la} do not match the main "
                 f"path's {want}")
        if not ms["graphs"]["graphs"]:
            fail(f"{arch}: the default engine did not run the horizon as "
                 "graphs")
        if any(las["plain"].values()):
            fail(f"{arch}: the plain-path engine launched a kernel "
                 f"{las['plain']}")
        diag = ((lambda: first_router_flip(cfg, params, kw)) if cfg.is_moe
                else None)
        compare_tokens(f"models {arch}", cfg, params, prompts,
                       outs["graphs"], outs["plain"], ("graphs", "plain"),
                       diagnose=diag)
        if cfg.is_moe:
            print(f"[models] {arch} plain path, eager: "
                  + moe_drops(cfg, params, kw), flush=True)
        for way, m in ms.items():
            if m["completed"] != m["n"] or m["pages_in_use"] \
                    or m["bal_max"] or m["bal_min"]:
                fail(f"{arch} {way}: completed {m['completed']}/{m['n']}, "
                     f"{m['pages_in_use']} pages in use")
        if ms["graphs"]["device_syncs"] != ms["plain"]["device_syncs"]:
            fail(f"{arch}: device syncs differ between the graph and plain "
                 "paths")
        for k, v in la.items():
            launches[k] = launches.get(k, 0) + v
        phase_profile(cfg, params, prompts, smi, dict(
            max_prefill=cap, n_pages=n_pages, max_context=max_ctx))
        del params
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[models] phase 9 in {time.perf_counter() - t0:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# 10. the request lifecycle and telemetry
# ---------------------------------------------------------------------------

LIFE_DIR = HERE / "build" / "lifecycle"
# phase 10's engine beyond kv_engine's: batched prefill, horizon 4
LIFE = dict(prefill_mode="batched", decode_horizon=4, kernel_splits=4)


def path_launches(cfg, engines) -> dict:
    """The launches the engines' decode steps, rounds and prefill calls
    imply (``expected_launches``), summed. An entry may be a cluster: its
    every engine counts (``EngineCluster.engines``: dead and rebuilt ones
    included)."""
    want: dict[str, int] = {}
    for e in [x for c in engines for x in getattr(c, "engines", [c])]:
        tm = e.timing
        m = {"decode_steps": tm.decode_steps,
             "prefill_calls": tm.prefill_calls,
             "encoder_calls": tm.encoder_calls, "spec": e.spec,
             "draft_catchups": tm.draft_catchups,
             "spec_dispatches": dict(tm.spec_dispatches)}
        if e.spec:
            m.update(draft_layers=e.draft_cfg.n_layers,
                     draft_grp=e.draft_cfg.n_heads // e.draft_cfg.n_kv_heads)
        for k, v in expected_launches(cfg, m).items():
            want[k] = want.get(k, 0) + v
    return want


def check_main_path(label, cfg, engines, la, launches,
                    tag: str = "lifecycle") -> None:
    """Launches of one run (phases 10 and 11) against what its engines'
    steps and calls imply, every engine on the graph path; adds them to
    the main path's ``launches``."""
    if not all(e.horizons.graphs for c in engines
               for e in getattr(c, "engines", [c])):
        fail(f"{label}: an engine is not on the graph path")
    want = path_launches(cfg, engines)
    print(f"[{tag}] {label} launches: " + " ".join(
        f"{k}={la[k]} (expected {want[k]})" for k in la if want[k] or la[k]),
        flush=True)
    if la != want or not all(la[k] for k in la if want[k]):
        fail(f"{label}: kernel launches {la} do not match {want}")
    for k, v in la.items():
        launches[k] = launches.get(k, 0) + v


def life_telemetry(cfg, params, prompts, smi, launches, fns) -> None:
    """(a) telemetry off against on (metrics, trace, request log), after
    an unreported warm-up run, in turns: off, on, on, off."""
    from repro_torch.telemetry import (TelemetryConfig, parse_exposition,
                                       validate_trace)
    from repro_torch.telemetry.chrome_trace import ENGINE_PID, TRACKS
    from repro_torch.telemetry.prom import MetricsServer
    LIFE_DIR.mkdir(parents=True, exist_ok=True)
    trace_path = LIFE_DIR / "lifecycle.perfetto.json"
    log_path = LIFE_DIR / "records.jsonl"
    log_path.unlink(missing_ok=True)
    serve_kv(cfg, params, prompts[:2], **LIFE)
    runs = {}
    for label in ("off", "on", "on 2", "off 2"):
        tel = None
        if label == "on":
            tel = TelemetryConfig(metrics=True, trace_path=str(trace_path),
                                  request_log=str(log_path))
        elif label == "on 2":
            tel = TelemetryConfig(metrics=True, trace=True)
        gauges: dict[str, list] = {}

        def sample(e):
            if e.tel.enabled:
                for g in ("pim_hbm_bytes_per_token", "pim_channel_util",
                          "dpa_page_waste_ratio", "dpa_static_pages_saved"):
                    gauges.setdefault(g, []).append(e.tel.registry.get(g))
        reset_counts(fns)
        out, m = serve_kv(cfg, params, prompts, sample=sample, keep=True,
                          telemetry=tel, **LIFE)
        la = launch_counts(fns)
        eng = m["engine"]
        check_main_path(f"(a) telemetry {label}", cfg, [eng], la, launches)
        runs[label] = (out, eng, la, m["wall_s"], gauges)
    print("[lifecycle] (a) telemetry " + " | ".join(
        f"{label}: wall={w:.3f} s host_us/step="
        f"{e.timing.as_dict()['host_us_per_step']:.1f} steps="
        f"{e.timing.steps} syncs={e.timing.device_syncs}"
        for label, (_, e, _, w, _) in runs.items()) + f" | {smi}",
        flush=True)
    out0, e0, la0, _, _ = runs["off"]
    out1, e1, la1, _, gauges = runs["on"]
    for label, (out, e, la, _, _) in runs.items():
        if out != out0:
            fail(f"(a) telemetry {label} changed the greedy tokens")
        if e.timing.device_syncs != e0.timing.device_syncs \
                or e.timing.decode_tokens != e0.timing.decode_tokens:
            fail(f"(a) telemetry {label} changed device syncs or decode "
                 "tokens")
        if la != la0:
            fail(f"(a) telemetry {label} changed the kernel launches: {la} "
                 f"vs {la0}")
    tel = e1.tel
    srv = MetricsServer(tel.registry, 0)
    try:
        text = srv.scrape()
    finally:
        if not srv.close():
            fail("(a) the metrics server's thread did not stop")
    samples = parse_exposition(text)
    n_ev = tel.save_trace()
    tel.close()
    info = validate_trace(json.loads(trace_path.read_text()))
    for track in ("host", "dispatch", "sync", "device"):
        if (ENGINE_PID, TRACKS[track]) not in info["tracks"]:
            fail(f"(a) the trace has no {track} track")
    recs = [json.loads(x) for x in log_path.read_text().splitlines() if x]
    if len(recs) != len(prompts) or not all(r["finished"] for r in recs):
        fail(f"(a) request log holds {len(recs)} records")
    worst = 0.0
    for r in tel.tracker.records:
        legacy = e1.first_tok_t[r.req_id] - e1.submit_t[r.req_id]
        worst = max(worst, abs(r.ttft_s - legacy))
    if worst > 1e-9:
        fail(f"(a) the tracker's TTFT differs from the engine's by {worst}")
    g = tel.registry.get
    if g("engine_device_syncs_total") != e1.timing.device_syncs:
        fail("(a) the registry's device syncs differ from the engine's")
    sm = tel.summary()
    print(f"[lifecycle] (a) exposition: {len(samples)} samples parsed; "
          f"trace: {n_ev} events, {info['slices']} slices, "
          f"{len(info['tracks'])} tracks valid; request log: {len(recs)} "
          f"records; tracker TTFT = engine TTFT (max diff {worst:.1e} s); "
          f"ttft p50/p99 {sm['ttft_p50_ms']:.1f}/{sm['ttft_p99_ms']:.1f} ms "
          f"tpot p50 {sm.get('tpot_p50_ms', 0):.3f} ms queue p50 "
          f"{sm.get('queue_p50_ms', 0):.1f} ms", flush=True)
    tok = e1.timing.decode_tokens
    hbm = g("pim_modeled_hbm_bytes_total")
    print("[lifecycle] (a) PIM counters: modeled HBM bytes "
          f"{hbm:.0f} ({hbm / max(1, tok):.0f} B/token over {tok} decode "
          f"tokens) kv_bytes/token {tel.pim.kv_bytes_per_token():.0f} "
          f"bucket high-water {g('decode_table_bucket_highwater'):.0f} "
          f"pages peak {g('kv_pages_in_use_peak', {'tier': 'device'}):.0f}"
          + "".join(f" {k} mean/max {np.mean(v):.4g}/{np.max(v):.4g}"
                    for k, v in gauges.items()), flush=True)
    for _, e, _, _, _ in runs.values():
        if e.alloc.pages_in_use or e.batcher.stats.completed != len(prompts):
            fail("(a) a run did not complete or leaked pages")
    del e0, e1, runs
    gc.collect()
    torch.cuda.empty_cache()


def life_prefix_ttft(cfg, params, smi) -> None:
    """(b) phase 7's shared-prefix run (16 requests of 512-1024 tokens,
    90% shared, prefix cache on, batched) with the tracker on: TTFT of hit
    and cold requests split into queue (submit -> admission), capture
    (graph captures inside the TTFT window) and prefill (the rest after
    admission)."""
    from repro_torch.telemetry import TelemetryConfig
    prompts = shared_prompts(cfg.vocab_size, 16, 512, 1024, 0.9, 1280)
    eng = kv_engine(cfg, params, prefix_cache=True,
                    telemetry=TelemetryConfig(metrics=True), **LIFE)
    caps: list[tuple[float, float]] = []
    capture = eng.horizons.capture

    def timed(key):
        t = time.perf_counter()
        capture(key)
        caps.append((t, time.perf_counter()))
    eng.horizons.capture = timed
    _, m = serve_kv(cfg, params, prompts, eng=eng, keep=True)
    matched, wall = m["matched"], m["wall_s"]
    split = {"hit": [], "cold": []}
    for r in eng.tel.tracker.records:
        lo, hi = r.submit_t, r.first_token_t
        cap = sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in caps)
        cap_after = sum(max(0.0, min(b, hi) - max(a, r.admit_t))
                        for a, b in caps)
        split["hit" if matched.get(r.req_id, 0) else "cold"].append(
            (1e3 * r.ttft_s, 1e3 * r.queue_s, 1e3 * cap,
             1e3 * (hi - r.admit_t - cap_after)))
    for kind, rows in split.items():
        if not rows:
            continue
        a = np.asarray(rows)
        print(f"[lifecycle] (b) shared prefix, {kind} ({len(rows)} "
              f"requests): ttft mean {a[:, 0].mean():.1f} ms = queue "
              f"{a[:, 1].mean():.1f} ms (submit -> admission) + prefill "
              f"{a[:, 3].mean():.1f} ms (admission -> first token, less "
              f"captures); captures inside the TTFT window "
              f"{a[:, 2].mean():.1f} ms; ttft max {a[:, 0].max():.1f} ms "
              f"| {smi}", flush=True)
    print(f"[lifecycle] (b) {len(caps)} graph captures, "
          f"{1e3 * sum(b - a for a, b in caps):.1f} ms; wall {wall:.3f} s; "
          f"hits {eng.cache.stats.hits}/{eng.cache.stats.lookups}",
          flush=True)
    if eng.batcher.stats.completed != len(prompts) or not split["hit"]:
        fail("(b) the shared-prefix run did not complete or never hit")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def life_chaos(cfg, params, smi, launches, fns) -> None:
    """(c) the chaos scenarios of ``launch/chaos_soak.py`` at full width on
    the graph path: llama3.2-1b's fp32 weights, a 1-layer full-width draft
    (seed 7), the scenarios' 4 slots at 16-token pages (prompts, new tokens
    and context 4x the reference's, so each keeps its page counts) and
    horizon 4 (the ladder's bit 1 then captures horizon-1 graphs). Seeds 0
    and 1, seed 0 twice: every request terminal and no page leaked (the
    scenarios assert it), outputs held to a clean run under the near-tie
    rule, the two runs of one seed identical in event log and outputs,
    each run's launches what its engines' steps and calls imply, and every
    captured graph counted."""
    from repro_torch.launch.chaos_soak import ChaosSoak
    from repro_torch.models.model import init_params
    dcfg = replace(cfg, name=cfg.name + "-draft", n_layers=1)

    def same(what, prompts, ref, outs):
        compare_tokens(f"lifecycle (c) {what}", cfg, params, prompts, ref,
                       outs, ("clean", "chaos"))
    soak = ChaosSoak(DEV, cfg=cfg, params=params, draft_cfg=dcfg,
                     draft_params=init_params(dcfg, seed=7,
                                              dtype=torch.float32,
                                              device=DEV),
                     page_size=16, same=same, **LIFE)
    # the cluster's scenario (dead engines release their graphs) is
    # phase 11's (b)
    for name in (n for n in ChaosSoak.SCENARIOS if n != "disagg"):
        got = {}
        for seed, rep in ((0, 0), (0, 1), (1, 0)):
            reset_counts(fns)
            t = time.perf_counter()
            stats, outs = getattr(soak, name)(seed)
            dt = time.perf_counter() - t
            la = launch_counts(fns)
            engs, soak.engines = soak.engines, []
            label = f"(c) {stats['scenario']}" + (" again" if rep else "")
            check_main_path(label, cfg, engs, la, launches)
            held = sum(len(e.horizons.captured) for e in engs)
            counted = sum(e.timing.graph_captures for e in engs)
            if counted != held or not held:
                fail(f"{label}: {counted} captures counted, {held} graphs "
                     "held")
            keys = stats["graph_keys"]
            if (stats["degraded_mode"] & 2) \
                    and not any(not spec for *_, spec in keys):
                fail(f"{label}: spec turned off but no plain horizon was "
                     "captured")
            got[seed, rep] = (stats, outs)
            if rep == 0:
                swap = {k: stats[k] for k in (
                    "swapped_out_pages", "swapped_in_pages", "swap_retries",
                    "swap_in_fails") if k in stats}
                why = {k: v for k, v in stats["abort_counts"].items() if v}
                print(f"[lifecycle] {label}: done={stats['completed']} "
                      f"aborted={stats['aborted']} {why}"
                      f" faults={stats['faults_fired']} degraded="
                      f"{stats['degraded_mode']} migrated="
                      f"{stats['migrated']} preempted={stats['preempted']} "
                      f"{swap or ''} captures={counted} over {len(engs)} "
                      f"engines, this engine's (width, K, spec) {keys} "
                      f"wall={dt:.2f} s", flush=True)
            del engs
            gc.collect()
        (s0, o0), (s1, o1) = got[0, 0], got[0, 1]
        if s0["events"] != s1["events"] or o0 != o1 \
                or s0["abort_counts"] != s1["abort_counts"]:
            fail(f"(c) {name}[0]: two runs of one seed differ")
    print(f"[lifecycle] (c) {len(ChaosSoak.SCENARIOS) - 1} scenarios x "
          "seeds 0, 1 at full width terminal and leak-free; seed 0 "
          f"replayed identically | {smi}", flush=True)
    del soak
    gc.collect()
    torch.cuda.empty_cache()


def life_restore(cfg, params, prompts, smi, launches, fns) -> None:
    """(d) kill and restore: snapshot at a mid-run tick, abandon the
    engine, restore into a fresh engine and finish; tokens equal the
    uninterrupted run's."""
    import shutil
    ref, _ = serve_kv(cfg, params, prompts, **LIFE)
    d = LIFE_DIR / "snapshots"
    shutil.rmtree(d, ignore_errors=True)
    eng = kv_engine(cfg, params, snapshot_dir=str(d), **LIFE)
    from repro_torch.serving import Request
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, 32))
    for _ in range(6):
        eng.tick()
    torch.cuda.synchronize()
    t = time.perf_counter()
    path = eng.save_snapshot()
    save_ms = 1e3 * (time.perf_counter() - t)
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    warm = sum(1 for e in json.loads((Path(path) / "manifest.json")
                                     .read_text())["extra"]["reqs"].values()
               if e["state"] == "warm")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng2 = kv_engine(cfg, params, snapshot_dir=str(d), **LIFE)
    torch.cuda.synchronize()
    t = time.perf_counter()
    step = eng2.restore_snapshot()
    restore_ms = 1e3 * (time.perf_counter() - t)
    reset_counts(fns)
    out, m = serve_kv(cfg, params, [], eng=eng2, keep=True)
    wall = m["wall_s"]
    la = launch_counts(fns)
    check_main_path("(d) restored run", cfg, [eng2], la, launches)
    print(f"[lifecycle] (d) snapshot at tick {step}: {warm} warm of "
          f"{len(prompts)} requests, {nbytes / 1e6:.1f} MB, save "
          f"{save_ms:.1f} ms; restore (validate + load + adopt) "
          f"{restore_ms:.1f} ms; rest of the run {wall:.3f} s, rstate "
          f"restores {eng2.rstate_restores} | {smi}", flush=True)
    compare_tokens("lifecycle (d) kill and restore", cfg, params, prompts,
                   ref, out, ("uninterrupted", "restored"))
    if eng2.alloc.pages_in_use or step is None:
        fail("(d) the restored run leaked pages or restored nothing")
    shutil.rmtree(d, ignore_errors=True)
    del eng2
    gc.collect()
    torch.cuda.empty_cache()


def life_slo(smi) -> None:
    """(e) the SLO trace at the bench's configuration (reduced
    llama3.2-1b, ``launch/slo_bench.py``) with the kernels and on the plain
    paths: every counter equal to ``BENCH_slo.json``'s row and between the
    two, tokens compared under the near-tie rule."""
    from repro_torch.data import workload
    from repro_torch.launch import slo_bench
    base = {r["policy"]: r for r in json.loads(
        (HERE / "BENCH_slo.json").read_text())["rows"]}
    trace = workload.load_trace(slo_bench.DEFAULT_TRACE)
    cfg = slo_bench.bench_config()
    from repro_torch.models.model import init_params
    params = init_params(cfg, 0, torch.float32, DEV)
    rows = {}
    for way, uk in (("kernels", None), ("plain", False)):
        t = time.perf_counter()
        rows[way] = {r["policy"]: r for r in slo_bench.bench(
            params=params, device=DEV, use_kernels=uk)}
        print(f"[lifecycle] (e) SLO bench, {way}: "
              f"{time.perf_counter() - t:.2f} s", flush=True)
    prompts = {ev["req_id"]: workload.prompt_tokens(trace, ev,
                                                    cfg.vocab_size)
               for ev in trace["events"] if ev["kind"] == "submit"}
    for pol, want in base.items():
        for way in rows:
            got = {k: v for k, v in rows[way][pol].items() if k != "outputs"}
            diff = {k: (got.get(k), v) for k, v in want.items()
                    if got.get(k) != v}
            print(f"[lifecycle] (e) {pol} {way}: goodput {got['goodput']} "
                  f"(BENCH_slo.json {want['goodput']}) slo_attained "
                  f"{got['slo_attained']} ({want['slo_attained']}) completed "
                  f"{got['completed']} ({want['completed']}) ticks "
                  f"{got['ticks']} ({want['ticks']}) priority_preempted "
                  f"{got['priority_preempted']} "
                  f"({want['priority_preempted']}) tokens {got['tokens']} "
                  f"({want['tokens']})", flush=True)
            if diff:
                fail(f"(e) {pol} {way}: counters differ from "
                     f"BENCH_slo.json: {diff}")
        compare_tokens(f"lifecycle (e) {pol}", cfg, params, prompts,
                       rows["kernels"][pol]["outputs"],
                       rows["plain"][pol]["outputs"], ("kernels", "plain"))
    print(f"[lifecycle] (e) every SLO counter equals BENCH_slo.json's | "
          f"{smi}", flush=True)


def life_step(cfg, params, prompts, smi, launches, fns) -> None:
    """(f) ``step()`` (the per-token tick on host logits) against ``run()``
    on the graph path: greedy tokens identical."""
    ref, m = serve_kv(cfg, params, prompts, **LIFE)
    wall_run = m["wall_s"]
    from repro_torch.serving import Request
    eng = kv_engine(cfg, params, **LIFE)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, 32))
    reset_counts(fns)
    torch.cuda.synchronize()
    t = time.perf_counter()
    n = 0
    while not eng.batcher.done():
        eng.step()
        n += 1
        if n > 100_000:
            fail("(f) step() did not finish")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    la = launch_counts(fns)
    check_main_path("(f) step()", cfg, [eng], la, launches)
    out = {k: list(v) for k, v in eng.outputs.items()}
    tm = eng.timing
    print(f"[lifecycle] (f) step(): {n} ticks, {tm.decode_steps} decode "
          f"steps, decode ms/step "
          f"{1e3 * tm.decode_s / max(1, tm.decode_steps):.2f}, syncs "
          f"{tm.device_syncs}, wall {wall:.3f} s against run() "
          f"{wall_run:.3f} s | {smi}", flush=True)
    compare_tokens("lifecycle (f) step() vs run()", cfg, params, prompts,
                   ref, out, ("run()", "step()"))
    if eng.alloc.pages_in_use:
        fail("(f) step() leaked pages")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def phase_lifecycle(smi: str, launches: dict) -> None:
    """Phase 10: the request lifecycle and telemetry on the graph path,
    llama3.2-1b at full width (random fp32 weights from seed 0, fp32 pool,
    page 16, 8 slots, batched prefill, horizon 4): (a) telemetry off
    against on, (b) the shared-prefix TTFT split, (c) the chaos scenarios
    (on their own 4 slots), (d) kill and restore, (e) the SLO trace at the
    bench's configuration, (f) ``step()`` against ``run()``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    fns = _kernel_fns()
    cfg = replace(get_config("llama3.2-1b"), dtype="float32")
    params = init_params(cfg, seed=0, dtype=torch.float32, device=DEV)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n_tok))
               for n_tok in rng.integers(256, 1025, 8)]
    steps = (("a", lambda: life_telemetry(cfg, params, prompts, smi,
                                           launches, fns)),
             ("b", lambda: life_prefix_ttft(cfg, params, smi)),
             ("c", lambda: life_chaos(cfg, params, smi, launches, fns)),
             ("d", lambda: life_restore(cfg, params, prompts[:6], smi,
                                        launches, fns)),
             ("e", lambda: life_slo(smi)),
             ("f", lambda: life_step(cfg, params, prompts[:4], smi,
                                     launches, fns)))
    for label, fn in steps:
        t = time.perf_counter()
        fn()
        print(f"[lifecycle] ({label}) in {time.perf_counter() - t:.1f} s",
              flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[lifecycle] phase 10 in {time.perf_counter() - t0:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# 11. disaggregated serving
# ---------------------------------------------------------------------------

def cluster_engine_cfg(**kw):
    """Phase 11's engine: ``kv_engine``'s geometry (8 slots, page 16, 1024
    pages, context 1280) and phase 10's path (batched, horizon 4, 4
    splits)."""
    from repro_torch.serving import EngineConfig
    return EngineConfig(n_slots=8, page_size=16, n_pages=1024,
                        max_context=1280, eos_token=-1, **{**LIFE, **kw})


def dis_clean(cfg, params, prompts, smi, launches, fns) -> None:
    """(a) one prefill and one decode engine against the colocated engine:
    tokens (near-tie rule), handoffs, launches, handoff MB and ms, decode
    tok/s, graph captures."""
    from repro_torch.serving import ClusterConfig, EngineCluster, Request
    serve_kv(cfg, params, prompts[:2], **LIFE)        # warm-up, unreported
    reset_counts(fns)
    ref, m = serve_kv(cfg, params, prompts, keep=True, **LIFE)
    check_main_path("(a) colocated", cfg, [m["engine"]], launch_counts(fns),
                    launches, "disagg")
    col = m["engine"].timing
    reset_counts(fns)
    cl = EngineCluster(cfg, cluster_engine_cfg(), ClusterConfig(), params,
                       device=DEV)
    for i, p in enumerate(prompts):
        cl.submit(Request(i, p, 32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = {k: list(v) for k, v in cl.run(100_000).items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_main_path("(a) disagg 1p+1d", cfg, [cl], launch_counts(fns),
                    launches, "disagg")
    c, T = cl.counters, cl.transfer
    n = len(prompts)
    bad = {k: v for k, v in c.items() if k not in ("handoffs", "handoff_ok")
           and v}
    if c["handoffs"] != n or c["handoff_ok"] != n or bad:
        fail(f"(a) router counters {c}: want {n} handoffs, all applied, "
             "no failure")
    pre, dec = (h.eng for h in cl.handles)
    for e in (pre, dec):
        if e.alloc.pages_in_use or not e.horizons.graphs:
            fail("(a) an engine leaked pages or left the graph path")
    nbytes = T.applied_bytes
    ctx = sum(len(p) for p in prompts)

    def tok_s(tm):
        return tm.decode_tokens / max(tm.decode_s, 1e-9)
    print(f"[disagg] (a) 1 prefill + 1 decode engine: {n} handoffs, "
          f"{nbytes / 1e6:.1f} MB ({nbytes / ctx:.0f} B a prompt token), "
          f"extract {1e3 * T.extract_s:.1f} ms, encode "
          f"{1e3 * T.encode_s:.1f} ms, decode {1e3 * T.decode_s:.1f} ms, "
          f"apply {1e3 * T.apply_s:.1f} ms (all {n}); wall {wall:.3f} s "
          f"against colocated {m['wall_s']:.3f} s | {smi}", flush=True)
    print(f"[disagg] (a) decode tok/s: decode engine {tok_s(dec.timing):.1f}"
          f" (prefill engine {tok_s(pre.timing):.1f}) against colocated "
          f"{tok_s(col):.1f}; syncs/token decode engine "
          f"{dec.timing.device_syncs / max(1, dec.timing.decode_tokens):.4f}"
          f" colocated {col.device_syncs / max(1, col.decode_tokens):.4f}; "
          f"graph captures prefill {pre.timing.graph_captures} "
          f"{sorted(pre.horizons.captured)} decode "
          f"{dec.timing.graph_captures} {sorted(dec.horizons.captured)} "
          f"colocated {col.graph_captures}; decode steps prefill / decode "
          f"{pre.timing.decode_steps} / {dec.timing.decode_steps}, prefill "
          f"calls {pre.timing.prefill_calls} / {dec.timing.prefill_calls} | "
          f"{smi}", flush=True)
    compare_tokens("disagg (a) 1p+1d vs colocated", cfg, params, prompts,
                   ref, out, ("colocated", "disagg"))
    del cl, pre, dec, m
    gc.collect()
    torch.cuda.empty_cache()


def dis_chaos(cfg, params, smi, launches, fns) -> None:
    """(b) ``ChaosSoak.disagg`` at full width on the graph path, seeds 0,
    1, 0 again and 3 (whose two rebuilt engines decode, and one dies again
    with its graphs captured): engine death rebuilt warm on the same card,
    torn and corrupt handoffs, backpressure; device memory around each
    rebuild."""
    from repro_torch.launch.chaos_soak import ChaosSoak
    from repro_torch.serving import EngineCluster

    def same(what, prompts, ref, outs):
        compare_tokens(f"disagg (b) {what}", cfg, params, prompts, ref,
                       outs, ("clean", "chaos"))
    soak = ChaosSoak(DEV, cfg=cfg, params=params, page_size=16, same=same,
                     **LIFE)
    kill, mem = EngineCluster._kill, []

    def measured_kill(self, h):
        torch.cuda.synchronize()
        mem.append([torch.cuda.memory_allocated(),
                    torch.cuda.max_memory_allocated()])
        torch.cuda.reset_peak_memory_stats()
        kill(self, h)
        torch.cuda.synchronize()
        mem[-1].append(torch.cuda.memory_allocated())
    EngineCluster._kill = measured_kill
    got, rebuilt_decoded = {}, 0
    try:
        for seed, rep in ((0, 0), (0, 1), (1, 0), (3, 0)):
            mem.clear()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(fns)
            t = time.perf_counter()
            stats, outs = soak.disagg(seed)
            dt = time.perf_counter() - t
            la = launch_counts(fns)
            engs, soak.engines = soak.engines, []
            peak_end = torch.cuda.max_memory_allocated()
            label = f"(b) {stats['scenario']}" + (" again" if rep else "")
            check_main_path(label, cfg, engs, la, launches, "disagg")
            # engs: the clean engine, then the cluster's in build order
            cl_engs = engs[1:]
            dead = [e for e in cl_engs if not e.state]
            live = [e for e in cl_engs if e.state]
            for e in dead:
                if e.horizons.captured or e.dev is not None:
                    fail(f"{label}: a dead engine kept its graphs or state")
            for e in live + engs[:1]:
                if e.timing.graph_captures != len(e.horizons.captured):
                    fail(f"{label}: captures counted and held differ")
            # engines rebuilt from a snapshot (a rebuild whose restore
            # found none was released at once; a rebuilt one may die too)
            rebuilt = [e for e in cl_engs[2:] if e.snapshot_restores]
            if not all(e.timing.graph_captures for e in rebuilt
                       if e.timing.decode_steps):
                fail(f"{label}: a rebuilt engine decoded without a graph "
                     "of its own")
            rebuilt_decoded += sum(1 for e in rebuilt
                                   if e.timing.decode_steps)
            c = stats["cluster"]
            if c["engine_restores"] != len(rebuilt):
                fail(f"{label}: {c['engine_restores']} restores, "
                     f"{len(rebuilt)} rebuilt engines")
            got[seed, rep] = (stats, outs)
            if rep == 0:
                print(f"[disagg] {label}: done={stats['completed']} "
                      f"shed={c['shed']} faults={stats['fault_counts']} "
                      f"router {c} degraded={stats['degraded_mode']} "
                      f"engines built {len(cl_engs)} (dead {len(dead)}, "
                      f"rebuilt {len(rebuilt)}), captures "
                      f"{[e.timing.graph_captures for e in cl_engs]}, "
                      f"device MB at each death allocated / peak before "
                      f"-> allocated after rebuild: "
                      + ", ".join(f"{a / 2**20:.0f} / {p / 2**20:.0f} -> "
                                  f"{b / 2**20:.0f}" for a, p, b in mem)
                      + f"; peak after {peak_end / 2**20:.0f} MB, wall "
                      f"{dt:.2f} s | {smi}", flush=True)
            del engs, cl_engs, dead, live, rebuilt
            gc.collect()
    finally:
        EngineCluster._kill = kill
    (s0, o0), (s1, o1) = got[0, 0], got[0, 1]
    if s0["events"] != s1["events"] or o0 != o1 \
            or s0["cluster"] != s1["cluster"]:
        fail("(b) disagg[0]: two runs of one seed differ")
    if not rebuilt_decoded:
        fail("(b) no rebuilt engine decoded: the rebuild path did not run")
    print(f"[disagg] (b) disagg seeds 0, 1, 3 at full width terminal and "
          f"leak-free; seed 0 replayed identically; {rebuilt_decoded} "
          f"rebuilt engines decoded on graphs of their own | {smi}",
          flush=True)
    del soak
    gc.collect()
    torch.cuda.empty_cache()


def dis_static(cfg, params, smi, launches, fns) -> None:
    """(c) lazy (DPA) against static allocation through ``serve``'s
    ``--static`` path at full width: 6 slots, context 2048 (static
    reserves 129 pages a request), a 288-page pool (2 static requests
    fit)."""
    from repro_torch.launch import serve as SV
    argv = ["--full-width", "--device", DEV, "--requests", "12", "--slots",
            "6", "--page", "16", "--pages", "288", "--max-context", "2048",
            "--mean-new", "32", "--decode-horizon", "4",
            "--kernel-splits", "4"]
    res = {}
    for mode, extra in (("lazy", []), ("static", ["--static"])):
        reset_counts(fns)
        st = SV.serve(argv + extra)
        la = launch_counts(fns)
        want = expected_launches(cfg, st)
        print(f"[disagg] (c) {mode} launches: " + " ".join(
            f"{k}={la[k]} (expected {want[k]})" for k in la
            if want[k] or la[k]), flush=True)
        if la != want or not la["paged_attention"] \
                or not la["flash_attention"]:
            fail(f"(c) {mode}: kernel launches {la} do not match {want}")
        for k, v in la.items():
            launches[k] = launches.get(k, 0) + v
        res[mode] = st
        print(f"[disagg] (c) {mode}: completed={st['completed']}/12 "
              f"peak pages {st['peak_pages']} avg_batch "
              f"{st['avg_batch']:.3f} decode tok/s {st['decode_tok_s']:.1f} "
              f"wall {st['wall_s']:.3f} s graph captures "
              f"{st['graph_captures']} | {smi}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    lazy, static = res["lazy"], res["static"]
    if lazy["completed"] != 12 or static["completed"] != 12:
        fail("(c) a run did not complete")
    if static["peak_pages"] > 2 * 129 or static["avg_batch"] >= \
            lazy["avg_batch"]:
        fail(f"(c) static allocation admitted as much as lazy: {static} "
             f"vs {lazy}")
    args = SV.parse_args(argv)
    prompts = [r.prompt for r in SV.trace_requests(args, cfg.vocab_size)]
    # serve builds its own weights from seed 0: ``params``' values
    compare_tokens("disagg (c) static vs lazy", cfg, params, prompts,
                   lazy["outputs"], static["outputs"], ("lazy", "static"))


def phase_disagg(smi: str, launches: dict) -> None:
    """Phase 11: disaggregated serving on the graph path, llama3.2-1b at
    full width (random fp32 weights from seed 0, shared by every engine):
    (a) a clean 1 prefill + 1 decode pool against one colocated engine,
    (b) the chaos scenario with engine deaths rebuilt warm on the same
    card, (c) lazy against static allocation through ``serve``."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params
    t0 = time.perf_counter()
    fns = _kernel_fns()
    cfg = replace(get_config("llama3.2-1b"), dtype="float32")
    params = init_params(cfg, seed=0, dtype=torch.float32, device=DEV)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n_tok))
               for n_tok in rng.integers(256, 1025, 8)]
    steps = (("a", lambda: dis_clean(cfg, params, prompts, smi, launches,
                                      fns)),
             ("b", lambda: dis_chaos(cfg, params, smi, launches, fns)),
             ("c", lambda: dis_static(cfg, params, smi, launches, fns)))
    for label, fn in steps:
        t = time.perf_counter()
        fn()
        print(f"[disagg] ({label}) in {time.perf_counter() - t:.1f} s",
              flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[disagg] phase 11 in {time.perf_counter() - t0:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# 12. xLSTM and the benches as entry points of the port
# ---------------------------------------------------------------------------

XL_TIGHT = 120                  # the preempting pool's pages (phase 7's)


def xl_metrics(m: dict) -> str:
    dec = m["decode_tokens"]
    return (f"ttft mean/max={m['ttft_mean_ms']:.1f}/{m['ttft_max_ms']:.1f} "
            f"ms decode tok/s={dec / max(m['decode_s'], 1e-9):.1f} "
            + (f"replay device ms/step={m['replay_step_ms']:.3f} "
               if m["replay_step_ms"] is not None else "")
            + f"syncs/token={m['device_syncs'] / max(1, dec):.4f}")


def xl_engine(cfg, params, smi: str, zref: dict | None) -> None:
    """(a) xlstm-350m at full width and depth: batched prefill at horizon
    4 on the graph path, eagerly and on the plain path; slot and chunked
    (128) prefill on the graph path; batched on a preempting pool with
    snapshots. Tokens equal the batched graph run's (near ties printed),
    no kernel launches, device syncs equal across the three batched ways,
    every request complete and every page released."""
    fns = _kernel_fns()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n_tok))
               for n_tok in rng.integers(256, 1025, 8)]
    # pow2 prefill buckets (256/512/1024): three sLSTM loops a batched run
    kw0 = dict(splits=4, n_req=8, chunk=128, max_prefill=1024, horizon=4,
               use_kernels=None)
    serve(cfg, params, prompts=prompts, mode="batched",
          **dict(kw0, n_req=2))         # first use of each shape: unreported
    runs = (("batched graphs", dict(mode="batched")),
            ("batched eager", dict(mode="batched", decode_graphs=False)),
            ("batched plain", dict(mode="batched", use_kernels=False)),
            ("slot", dict(mode="slot")),
            ("chunked", dict(mode="chunked")),
            ("batched state_resume", dict(mode="batched", n_pages=XL_TIGHT)))
    outs, ms = {}, {}
    for label, kw in runs:
        # the counts are set to 0 just before each run and read just after
        reset_counts(fns)
        outs[label], m = serve(cfg, params, prompts=prompts,
                               **dict(kw0, **kw))
        ms[label] = m
        la = launch_counts(fns)
        print(f"[xlstm] {cfg.name} {label}: completed={m['completed']}/"
              f"{m['n']} page balance max={m['bal_max']} min={m['bal_min']}"
              f" tokens={m['tokens']} wall={m['wall_s']:.3f} s "
              f"{xl_metrics(m)} prefill s={m['prefill_s']:.3f} "
              f"peak device MB={m['peak_bytes'] / 2**20:.1f} "
              f"graph captures={m['graph_captures']} capture ms="
              f"{1e3 * m['capture_s']:.1f} preempted={m['preempted']} "
              f"restores={m['rstate_restores']} decode_steps="
              f"{m['decode_steps']} prefill_calls={m['prefill_calls']} "
              f"launches {la} | {smi}", flush=True)
        if any(la.values()):
            fail(f"{cfg.name} {label}: a kernel launched on the xLSTM path "
                 f"{la}")
        if m["completed"] != m["n"] or m["bal_max"] or m["bal_min"] \
                or m["pages_in_use"] or m["rsnaps_left"]:
            fail(f"{cfg.name} {label}: completed {m['completed']}/{m['n']}, "
                 f"{m['pages_in_use']} pages and {m['rsnaps_left']} "
                 "snapshots left")
    if not ms["batched graphs"]["graphs"] or ms["batched eager"]["graphs"]:
        fail(f"{cfg.name}: the default engine did not run the horizon as "
             "graphs, or decode_graphs=False did")
    syncs = {w: ms[w]["device_syncs"] for w in
             ("batched graphs", "batched eager", "batched plain")}
    if len(set(syncs.values())) != 1:
        fail(f"{cfg.name}: device syncs differ across the ways: {syncs}")
    tight = ms["batched state_resume"]
    if not (tight["preempted"] and tight["rstate_restores"]):
        fail(f"{cfg.name}: the {XL_TIGHT}-page pool restored no preemption "
             f"({tight['preempted']} preempted)")
    for label, _ in runs[1:]:
        compare_tokens(f"{cfg.name} {label}", cfg, params, prompts,
                       outs["batched graphs"], outs[label],
                       ("batched graphs", label))
    z = (xl_metrics(zref) + f" peak device MB="
         f"{zref['peak_bytes'] / 2**20:.1f}") if zref else \
        "not run in this call (phase 5)"
    print(f"[xlstm] beside zamba2-1.2b batched graphs (phase 5): {z} | "
          f"{smi}", flush=True)


def _check_regression():
    """``benchmarks/check_regression.py`` (framework-free) as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "check_regression", HERE / "benchmarks" / "check_regression.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_launches_line(label, la, launches) -> None:
    """A bench's launches: K1 and K2 carry its llama rows, K4 has no
    Mamba2 row to run; added to the run's totals."""
    print(f"[bench] {label} launches: {la}", flush=True)
    if not (la["paged_attention"] and la["flash_attention"]) \
            or any(la[k] for k in la if k.startswith("ssm_scan")):
        fail(f"{label}: launches {la}: K1 and K2 must run, K4 must not")
    for k, v in la.items():
        launches[k] = launches.get(k, 0) + v


def xl_serving_bench(smi: str, launches: dict) -> None:
    """(b) ``launch/serving_bench.py`` at the baseline's sizes: the 12
    rows of ``BENCH_serving.json``, the counter layer of
    ``check_regression.check_serving`` clean, its timing layer printed."""
    from repro_torch.launch import serving_bench as SB
    fns = _kernel_fns()
    reset_counts(fns)
    rows = SB.run(lambda n, us, d: print(f"[bench] {n},{us:.2f},{d}",
                                         flush=True), device=DEV)
    la = launch_counts(fns)
    for r in rows:
        print(f"[bench] {r['trace']} {r['arch']} {r['mode']} "
              f"h{r['horizon']}: decode_tok_s={r.get('decode_tok_s')} "
              f"ttft_ms={r.get('ttft_ms')} syncs_per_token="
              f"{r.get('syncs_per_token')} tokens={r['tokens']}"
              + (f" accept_len_mean={r['accept_len_mean']}"
                 if "accept_len_mean" in r else "") + f" | {smi}",
              flush=True)
    base = json.loads((HERE / "BENCH_serving.json").read_text())
    fresh = {"bench": "serving", "rows": [
        {k: v for k, v in r.items() if k != "outputs"} for r in rows]}
    if len(rows) != len(base["rows"]):
        fail(f"serving_bench: {len(rows)} rows, the baseline has "
             f"{len(base['rows'])}")
    msgs = _check_regression().check_serving(base, [fresh], 0.20, False)
    timing = [m for m in msgs if "normalized" in m]
    counters = [m for m in msgs if "normalized" not in m]
    for m in timing:
        print(f"[bench] timing layer (reported, not asserted): {m}",
              flush=True)
    if counters:
        fail(f"serving_bench: counter layer against BENCH_serving.json: "
             f"{counters}")
    print(f"[bench] serving_bench: {len(rows)} rows, counter layer clean "
          f"against BENCH_serving.json, {len(timing)} timing messages",
          flush=True)
    bench_launches_line("serving_bench", la, launches)


def xl_kvcache_bench(smi: str, launches: dict) -> None:
    """(c) ``launch/kvcache_bench.py``'s ``run``, the entry point's own
    checks: each share level with and without the cache (outputs equal; at
    90% at least 16 hits and fewer pages; the TTFT ratio printed), then
    the host tier (admitted KV past the pool, swaps both ways)."""
    from repro_torch.launch import kvcache_bench as KB
    from repro_torch.models.model import init_params
    fns = _kernel_fns()
    params = init_params(KB.bench_config(), seed=0, dtype=torch.float32,
                         device=DEV)
    reset_counts(fns)
    rows = KB.run(lambda n, us, d: print(f"[bench] {n},{us:.2f},{d}",
                                         flush=True),
                  params=params, device=DEV)
    la = launch_counts(fns)
    for r in rows:
        print(f"[bench] {r} | {smi}", flush=True)
    bench_launches_line("kvcache_bench", la, launches)


def phase_xlstm(smi: str, launches: dict, zref: dict | None) -> None:
    """Phase 12: (a) xlstm-350m through the engine at full width and depth,
    (b) the port's serving bench, (c) its KV-cache bench."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, param_count_actual
    t0 = time.perf_counter()
    cfg = replace(get_config("xlstm-350m"), dtype="float32")
    params = init_params(cfg, seed=0, dtype=torch.float32, device=DEV)
    n = param_count_actual(params)
    print(f"[xlstm] {cfg.name}: {cfg.n_layers} layers ({cfg.n_layers // 2} "
          f"mLSTM + sLSTM cycles) d={cfg.d_model} d_inner={cfg.d_inner} "
          f"heads={cfg.n_heads} vocab={cfg.vocab_size} params={n} fp32 "
          f"({4 * n / 2**30:.2f} GiB)", flush=True)
    steps = (("a", lambda: xl_engine(cfg, params, smi, zref)),
             ("b", lambda: xl_serving_bench(smi, launches)),
             ("c", lambda: xl_kvcache_bench(smi, launches)))
    for label, fn in steps:
        t = time.perf_counter()
        fn()
        print(f"[xlstm] ({label}) in {time.perf_counter() - t:.1f} s",
              flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[xlstm] phase 12 in {time.perf_counter() - t0:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# 13. families: whisper-small (enc-dec), qwen2-vl-7b (M-RoPE), ring pools
# ---------------------------------------------------------------------------

FAM_DIR = HERE / "build" / "families"
# whisper's engine: 8 slots of 16-token pages over its 448 text positions,
# pow2 prefill buckets up to 512, horizon 4 (phase 5's batched path)
WHISPER = dict(splits=4, n_req=8, chunk=128, max_prefill=512, horizon=4,
               use_kernels=None, max_context=448)


def fam_metrics(m: dict) -> str:
    return (xl_metrics(m) + f" prefill s={m['prefill_s']:.3f} peak device "
            f"MB={m['peak_bytes'] / 2**20:.1f} graph captures="
            f"{m['graph_captures']} capture ms={1e3 * m['capture_s']:.1f} "
            f"decode_steps={m['decode_steps']} prefill_calls="
            f"{m['prefill_calls']} encoder_calls={m['encoder_calls']}")


def fam_launches(label, cfg, m, la, launches=None) -> None:
    """One run's launches against ``expected_launches``; the main path's
    (``launches`` given) are added to the totals."""
    want = expected_launches(cfg, m)
    print(f"[families] {label} launches: " + " ".join(
        f"{k}={la[k]} (expected {want[k]})" for k in la if want[k] or la[k]),
        flush=True)
    if la != want or not all(la[k] for k in la if want[k]):
        fail(f"{label}: kernel launches {la} do not match {want}")
    if launches is not None:
        for k, v in la.items():
            launches[k] = launches.get(k, 0) + v


def whisper_engine(cfg, params, **kw):
    """``serve``'s engine at WHISPER's geometry (for the restore and the
    cluster, which drive it themselves)."""
    from repro_torch.serving import EngineConfig
    return EngineConfig(
        n_slots=8, page_size=16, n_pages=1024,
        max_context=WHISPER["max_context"], eos_token=-1,
        prefill_mode="batched", prefill_chunk=WHISPER["chunk"],
        decode_horizon=WHISPER["horizon"], kernel_splits=WHISPER["splits"],
        max_prefill=WHISPER["max_prefill"], **kw)


def fam_whisper(smi: str, launches: dict) -> None:
    """(a) whisper-small whole: batched h4 on graphs (the main path),
    eagerly and on the plain path, slot and chunked (128); kill and
    restore; a 1 + 1 cluster. Tokens equal the graph run's (near ties
    printed); launches by kernel equal what the steps and calls imply."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params, param_count_actual
    from repro_torch.serving import (ClusterConfig, DecodeEngine,
                                     EngineCluster, Request)
    cfg = replace(get_config("whisper-small"), dtype="float32")
    params = init_params(cfg, seed=0, dtype=torch.float32, device=DEV)
    n = param_count_actual(params)
    print(f"[families] {cfg.name}: {cfg.enc_layers} encoder + "
          f"{cfg.n_layers} decoder layers d={cfg.d_model} heads="
          f"{cfg.n_heads} enc_seq={cfg.enc_seq} vocab={cfg.vocab_size} "
          f"params={n} fp32 ({4 * n / 2**30:.2f} GiB); cross rows "
          f"{2 * 4 * cfg.n_layers * 8 * cfg.enc_seq * cfg.kv_dim / 2**20:.1f}"
          " MiB at 8 slots", flush=True)
    fns = _kernel_fns()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n_tok))
               for n_tok in rng.integers(128, 417, 8)]
    serve(cfg, params, prompts=prompts, mode="batched",
          **dict(WHISPER, n_req=2))     # first use of each shape: unreported
    runs = (("batched graphs", dict(mode="batched")),
            ("batched eager", dict(mode="batched", decode_graphs=False)),
            ("batched plain", dict(mode="batched", use_kernels=False)),
            ("slot", dict(mode="slot")),
            ("chunked", dict(mode="chunked")))
    outs, ms = {}, {}
    for label, kw in runs:
        # the counts are set to 0 just before each run and read just after
        reset_counts(fns)
        outs[label], m = serve(cfg, params, prompts=prompts,
                               **dict(WHISPER, **kw))
        ms[label] = m
        la = launch_counts(fns)
        print(f"[families] {cfg.name} {label}: completed={m['completed']}/"
              f"{m['n']} page balance max={m['bal_max']} min={m['bal_min']}"
              f" tokens={m['tokens']} wall={m['wall_s']:.3f} s "
              f"{fam_metrics(m)} | {smi}", flush=True)
        if label == "batched plain":
            if any(la.values()):
                fail(f"{cfg.name} plain: a kernel launched {la}")
        else:
            fam_launches(f"{cfg.name} {label}", cfg, m, la,
                         launches if label == "batched graphs" else None)
        if m["completed"] != m["n"] or m["bal_max"] or m["bal_min"] \
                or m["pages_in_use"]:
            fail(f"{cfg.name} {label}: completed {m['completed']}/{m['n']},"
                 f" {m['pages_in_use']} pages left")
    if not ms["batched graphs"]["graphs"] or ms["batched eager"]["graphs"]:
        fail(f"{cfg.name}: the default engine did not run the horizon as "
             "graphs, or decode_graphs=False did")
    for label, _ in runs[1:]:
        compare_tokens(f"{cfg.name} {label}", cfg, params, prompts,
                       outs["batched graphs"], outs[label],
                       ("batched graphs", label))
    ref = outs["batched graphs"]

    # kill and restore: snapshot at tick 6, a fresh engine restores it
    d = FAM_DIR / "snapshots"
    shutil.rmtree(d, ignore_errors=True)
    eng = DecodeEngine(cfg, whisper_engine(cfg, params, snapshot_dir=str(d)),
                       params, device=DEV)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p, 32))
    for _ in range(6):
        eng.tick()
    path = eng.save_snapshot()
    warm = sum(1 for e in json.loads((Path(path) / "manifest.json")
                                     .read_text())["extra"]["reqs"].values()
               if e["state"] == "warm")
    nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng2 = DecodeEngine(cfg, whisper_engine(cfg, params,
                                            snapshot_dir=str(d)),
                        params, device=DEV)
    rows = eng2.state["cross_k"].data_ptr()
    reset_counts(fns)
    step = eng2.restore_snapshot()
    out = {k: list(v) for k, v in eng2.run(100_000).items()}
    check_main_path("(a) restored run", cfg, [eng2], launch_counts(fns),
                    launches, "families")
    print(f"[families] {cfg.name} kill and restore: snapshot at tick {step},"
          f" {warm} warm of {len(prompts)} requests ({nbytes / 1e6:.1f} MB "
          f"with their cross rows), rstate restores {eng2.rstate_restores} "
          f"| {smi}", flush=True)
    if step is None or not warm or eng2.state["cross_k"].data_ptr() != rows \
            or eng2.alloc.pages_in_use:
        fail(f"{cfg.name}: the restore restored nothing, rebound the cross "
             "rows or leaked pages")
    compare_tokens(f"{cfg.name} kill and restore", cfg, params, prompts, ref,
                   out, ("uninterrupted", "restored"))
    shutil.rmtree(d, ignore_errors=True)
    del eng2
    gc.collect()
    torch.cuda.empty_cache()

    # a 1 prefill + 1 decode cluster: pages and cross rows handed over
    reset_counts(fns)
    cl = EngineCluster(cfg, whisper_engine(cfg, params), ClusterConfig(),
                       params, device=DEV)
    for i, p in enumerate(prompts):
        cl.submit(Request(i, p, 32))
    out = {k: list(v) for k, v in cl.run(100_000).items()}
    check_main_path("(a) disagg 1p+1d", cfg, [cl], launch_counts(fns),
                    launches, "families")
    c = cl.counters
    print(f"[families] {cfg.name} 1 prefill + 1 decode engine: "
          f"{c['handoffs']} handoffs, {c['handoff_ok']} applied, "
          f"{cl.transfer.applied_bytes / 1e6:.1f} MB | {smi}", flush=True)
    if not c["handoffs"] or c["handoff_ok"] != c["handoffs"]:
        fail(f"{cfg.name}: router counters {c}")
    compare_tokens(f"{cfg.name} disagg 1p+1d", cfg, params, prompts, ref,
                   out, ("colocated", "disagg"))
    del cl, params
    gc.collect()
    torch.cuda.empty_cache()


def _close_scaled(label, got, want, tol) -> float:
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    if not torch.isfinite(got).all() or err > tol * scale:
        fail(f"{label}: max |kernel - plain| {err:.3e} over {tol} x "
             f"{scale:.3f}")
    return err


def fam_qwen2vl(smi: str, launches: dict) -> None:
    """(b) qwen2-vl-7b whole: batched h4 on graphs against the plain path
    (tokens); at the model level 4 rows of 256 image positions (a 16 x 16
    grid: t 0, h = i // 16, w = i % 16, ``extra_embeds`` over them) and 64
    text positions at max + 1 on all three axes, then 8 decode steps: the
    kernel path's logits against the plain path's (3e-4 prefill, 4e-3
    decode, of max(1, |logits|), repro's model tolerances)."""
    from repro_torch.configs import get_config
    from repro_torch.core.paged_kv import PoolSpec
    from repro_torch.kernels.backend import KernelConfig
    from repro_torch.models import model as MDL
    cfg = replace(get_config("qwen2-vl-7b"), dtype="float32")
    params = MDL.init_params(cfg, seed=0, dtype=torch.float32, device=DEV)
    n = MDL.param_count_actual(params)
    print(f"[families] {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} mrope={cfg.mrope_sections} "
          f"params={n} fp32 ({4 * n / 2**30:.2f} GiB)", flush=True)
    fns = _kernel_fns()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n_tok))
               for n_tok in rng.integers(128, 513, 8)]
    kw = dict(WHISPER, max_context=1280, mode="batched")
    serve(cfg, params, prompts=prompts, **dict(kw, n_req=2))
    outs, ms = {}, {}
    for way, wkw in (("graphs", dict()), ("plain", dict(use_kernels=False))):
        reset_counts(fns)
        outs[way], m = serve(cfg, params, prompts=prompts, **dict(kw, **wkw))
        ms[way] = m
        la = launch_counts(fns)
        print(f"[families] {cfg.name} batched {way}: completed="
              f"{m['completed']}/{m['n']} tokens={m['tokens']} wall="
              f"{m['wall_s']:.3f} s {fam_metrics(m)} | {smi}", flush=True)
        if way == "graphs":
            fam_launches(f"{cfg.name} graphs", cfg, m, la, launches)
        elif any(la.values()):
            fail(f"{cfg.name} plain: a kernel launched {la}")
        if m["completed"] != m["n"] or m["pages_in_use"]:
            fail(f"{cfg.name} {way}: incomplete or leaked pages")
    compare_tokens(f"{cfg.name} batched", cfg, params, prompts,
                   outs["graphs"], outs["plain"], ("graphs", "plain"))

    B, n_img, n_txt, steps, page = 4, 256, 64, 8, 16
    S = n_img + n_txt
    W = -(-(S + steps) // page)
    g = torch.Generator(device=DEV).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=g,
                         device=DEV, dtype=torch.int32)
    ee = torch.randn(B, S, cfg.d_model, generator=g, device=DEV) * 0.02
    ee[:, n_img:] = 0
    i = torch.arange(n_img, device=DEV)
    img = torch.stack([torch.zeros_like(i), i // 16, i % 16])   # [3, 256]
    txt = (img.max() + 1 + torch.arange(n_txt + steps, device=DEV))
    pos = torch.cat([img, txt[None].expand(3, -1)], 1)          # [3, S+8]
    pos = pos[:, None].expand(3, B, S + steps).to(torch.int32)
    bt = torch.arange(B * W, dtype=torch.int32, device=DEV).reshape(B, W)
    spec = PoolSpec(cfg.n_layers, B * W, page, cfg.n_kv_heads, cfg.d_head,
                    W, dtype="float32")
    logits = {}
    for way, kc in (("kernels", KernelConfig(n_splits=4)),
                    ("plain", KernelConfig(use_kernels=False))):
        rt = MDL.Runtime(kernels=kc)
        state = MDL.init_decode_state(cfg, spec, B, device=DEV)
        out = [MDL.prefill(cfg, params, state, toks[:, :S], bt,
                           positions=pos[:, :, :S], extra_embeds=ee,
                           rt=rt)[0]]
        for t in range(S, S + steps):
            ctx = torch.full((B,), t + 1, dtype=torch.int32, device=DEV)
            out.append(MDL.decode_step(
                cfg, params, state, toks[:, t], bt, ctx, bt[:, t // page],
                torch.full((B,), t % page, dtype=torch.int32, device=DEV),
                positions=pos[:, :, t:t + 1], rt=rt)[0])
        logits[way] = out
        del state
    pre = _close_scaled(f"{cfg.name} M-RoPE prefill", logits["kernels"][0],
                        logits["plain"][0], 3e-4)
    dec = max(_close_scaled(f"{cfg.name} M-RoPE decode {t}", a, b, 4e-3)
              for t, (a, b) in enumerate(zip(logits["kernels"][1:],
                                             logits["plain"][1:])))
    print(f"[families] {cfg.name} M-RoPE (16 x 16 grid + 64 text "
          f"positions, {steps} decode steps, B {B}): kernel vs plain "
          f"logits max_abs_err prefill {pre:.3e} decode {dec:.3e} | {smi}",
          flush=True)
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()


def fam_ring(smi: str, launches: dict) -> None:
    """(c) mixtral-8x22b at full width, its first 2 of 56 layers (window
    4096 on every layer): 4 slots, slot prefill, prompts of 4600-6000
    tokens, 32 new, horizon 4, on ``Runtime(ring_width=258)`` against the
    full pool (tokens); at the model level a request held to 258 ring pages
    against the full pool's 376, its logits within 2e-4 of max(1, |logits|)
    of the full pool's and of the ring's with plain decode steps
    (``use_kernels=False``): K1's ring mode at mixtral's layout held to the
    plain ring attention through the model. The prefill stays on K2 in
    both: a plain prefill routes 1-2 of the 12000 top-2 expert choices
    otherwise (near ties), ring or not, which moves the logits by ~6e-3;
    phase 3 holds K2 at this prefill's shape instead."""
    from repro_torch.configs import get_config
    from repro_torch.core.allocator import PageAllocator
    from repro_torch.core.paged_kv import PoolSpec
    from repro_torch.kernels.backend import KernelConfig
    from repro_torch.models import model as MDL
    from repro_torch.serving import DecodeEngine, EngineConfig, Request
    cfg = replace(get_config("mixtral-8x22b"), dtype="float32", n_layers=2)
    params = MDL.init_params(cfg, seed=0, dtype=torch.float32, device=DEV)
    n = MDL.param_count_actual(params)
    page = 16
    W = (cfg.sliding_window + page) // page + 1
    print(f"[families] {cfg.name}: 2 of 56 layers d={cfg.d_model} heads="
          f"{cfg.n_heads}/{cfg.n_kv_heads} experts={cfg.n_experts} window="
          f"{cfg.sliding_window} ring_width={W} params={n} fp32 "
          f"({4 * n / 2**30:.2f} GiB)", flush=True)
    fns = _kernel_fns()
    kc = KernelConfig(n_splits=4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n_tok))
               for n_tok in rng.integers(4600, 6001, 4)]
    outs = {}
    for label, ring in (("full pool", 0), ("ring", W)):
        eng = DecodeEngine(cfg, EngineConfig(
            n_slots=4, page_size=page, n_pages=1600, max_context=6144,
            eos_token=-1, prefill_mode="slot", decode_horizon=4,
            kernel_splits=4), params, MDL.Runtime(ring_width=ring,
                                                  kernels=kc), device=DEV)
        reset_counts(fns)
        outs[label], m = serve_kv(cfg, params, prompts, eng=eng, keep=True)
        m["encoder_calls"] = 0
        fam_launches(f"{cfg.name} {label}", cfg, m, launch_counts(fns),
                     launches)
        dec = eng.timing.decode_tokens
        print(f"[families] {cfg.name} {label}: completed={m['completed']}/"
              f"{m['n']} peak pages={m['peak_pages']} ttft mean="
              f"{m['ttft_mean_ms']:.1f} ms decode tok/s="
              f"{dec / max(m['decode_s'], 1e-9):.1f} prefill s="
              f"{m['prefill_s']:.3f} prefiller={eng.prefiller.name} | {smi}",
              flush=True)
        if m["completed"] != m["n"] or m["pages_in_use"]:
            fail(f"{cfg.name} {label}: incomplete or leaked pages")
        if ring and m["peak_pages"] > 4 * W:
            fail(f"{cfg.name} ring: {m['peak_pages']} pages in use, more "
                 f"than 4 x {W}")
        del eng, m
        gc.collect()
        torch.cuda.empty_cache()
    compare_tokens(f"{cfg.name} ring", cfg, params, prompts,
                   outs["full pool"], outs["ring"], ("full pool", "ring"))

    steps, S = 8, 6000
    g = torch.Generator(device=DEV).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (1, S + steps), generator=g,
                         device=DEV, dtype=torch.int32)
    logits, held = {}, {}
    for label, ring, kdec in (("full pool", 0, kc), ("ring", W, kc),
                              ("ring plain decode", W,
                               KernelConfig(use_kernels=False))):
        width = W if ring else -(-(S + steps) // page)
        alloc = PageAllocator(1600, 1, page, ring_pages=ring or None)
        alloc.admit(0, S + steps)
        held[label] = len(alloc.pages_of(0))
        bt = torch.tensor(alloc.block_table(0, width)[None], device=DEV,
                          dtype=torch.int32)
        state = MDL.init_decode_state(cfg, PoolSpec(
            cfg.n_layers, 1600, page, cfg.n_kv_heads, cfg.d_head, width,
            dtype="float32", ring=bool(ring)), 1, device=DEV)
        rt = MDL.Runtime(ring_width=ring, kernels=kc)
        out = [MDL.prefill(cfg, params, state, toks[:, :S], bt, rt=rt)[0]]
        rt = MDL.Runtime(ring_width=ring, kernels=kdec)
        for t in range(S, S + steps):
            vp = (t // page) % ring if ring else t // page
            out.append(MDL.decode_step(
                cfg, params, state, toks[:, t], bt,
                torch.full((1,), t + 1, dtype=torch.int32, device=DEV),
                bt[:, vp], torch.full((1,), t % page, dtype=torch.int32,
                                      device=DEV), rt=rt)[0])
        logits[label] = torch.stack(out)
        del state
    err = _close_scaled(f"{cfg.name} ring logits", logits["ring"],
                        logits["full pool"], 2e-4)
    err_plain = _close_scaled(f"{cfg.name} ring logits against plain decode"
                              " steps", logits["ring"],
                              logits["ring plain decode"], 2e-4)
    print(f"[families] {cfg.name} ring at the model level: {S} + {steps} "
          f"tokens held in {held['ring']} ring pages against "
          f"{held['full pool']} (PageAllocator(ring_pages={W})); logits "
          f"max_abs_err vs the full pool {err:.3e}, vs the ring's plain "
          f"decode steps {err_plain:.3e} | {smi}", flush=True)
    if held["ring"] != W or held["full pool"] <= W:
        fail(f"{cfg.name}: the ring held {held['ring']} pages, the full "
             f"pool {held['full pool']}")
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()


def phase_families(smi: str, launches: dict) -> None:
    """Phase 13: (a) whisper-small, (b) qwen2-vl-7b, (c) the ring pool on
    mixtral-8x22b, each model freed before the next loads."""
    t0 = time.perf_counter()
    for label, fn in (("a", fam_whisper), ("b", fam_qwen2vl),
                      ("c", fam_ring)):
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        fn(smi, launches)
        print(f"[families] ({label}) in {time.perf_counter() - t:.1f} s, "
              f"peak device MB "
              f"{torch.cuda.max_memory_allocated() / 2**20:.1f}", flush=True)
    print(f"[families] phase 13 in {time.perf_counter() - t0:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# 14. train: the training path on the card
# ---------------------------------------------------------------------------

TRAIN_DIR = HERE / "build" / "train"
# phase 14's reduced cases: llama (dense), zamba2 (Mamba2 + shared
# attention), mixtral (MoE, its aux term) and xlstm (mLSTM + sLSTM)
TRAIN_REDUCED = ("llama3.2-1b", "zamba2-1.2b", "mixtral-8x22b", "xlstm-350m")


def to_dev(tree, device):
    from repro_torch.models.model import tree_map
    return tree_map(lambda t: t.to(device), tree)


def train_steps(cfg, params, batches, *, rt=None, opt_cfg=None,
                microbatches=1, device=DEV):
    """``len(batches)`` train steps from ``params`` (not modified) on
    ``device``: (params, opt state, losses, grad norms, step ms by CUDA
    events on the card)."""
    from repro_torch.models import model as MDL
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train import make_train_step, to_device
    step = make_train_step(cfg, rt or MDL.DEFAULT_RT,
                           opt_cfg or OPT.AdamWConfig(lr=1e-3,
                                                      warmup_steps=1),
                           microbatches=microbatches)
    opt = OPT.init(params)
    losses, gnorms, ms = [], [], []
    for b in batches:
        batch = to_device(b, device)
        if device == DEV:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        params, opt, m = step(params, opt, batch)
        if device == DEV:
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return params, opt, losses, gnorms, ms


def zero_launches(label, fns) -> None:
    la = launch_counts(fns)
    print(f"[train] {label} kernel launches: {la}", flush=True)
    if any(la.values()):
        fail(f"{label}: a train step launched a kernel: {la}")


def train_whole(arch: str, smi: str, fns, *, B: int, S: int, steps: int,
                repeat: bool) -> None:
    """(a) / (e): ``arch`` whole, random fp32 weights from seed 0,
    ``Runtime(remat=True)``, AdamW lr 1e-3 warmup 1, ``steps`` steps of
    ``TrainPipeline`` batches B x S (``repeat``: batch 0 every step, so
    the loss must fall)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TrainPipeline
    from repro_torch.models import model as MDL
    cfg = replace(get_config(arch), dtype="float32")
    params = MDL.init_params(cfg, seed=0, dtype=torch.float32, device=DEV)
    n = MDL.param_count_actual(params)
    pipe = TrainPipeline(cfg.vocab_size, S, B)
    batches = [pipe.batch(0 if repeat else i) for i in range(steps)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fns)
    _, _, losses, gnorms, ms = train_steps(
        cfg, params, batches, rt=MDL.Runtime(remat=True))
    zero_launches(arch, fns)
    peak = torch.cuda.max_memory_allocated()
    warm = ms[1:] or ms
    print(f"[train] {arch}: {cfg.n_layers} layers d={cfg.d_model} vocab="
          f"{cfg.vocab_size} params={n} B={B} S={S} remat, "
          f"{'batch 0 repeated' if repeat else 'batches 0..'}: step ms "
          + " ".join(f"{x:.1f}" for x in ms)
          + f"; tokens/s {B * S / (np.mean(warm) / 1e3):.0f} (steps 2..) "
          f"peak device MB {peak / 2**20:.1f} | {smi}", flush=True)
    print(f"[train] {arch} loss by step: "
          + " ".join(f"{x:.4f}" for x in losses) + " | grad norm: "
          + " ".join(f"{x:.4f}" for x in gnorms), flush=True)
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        fail(f"{arch}: a loss or grad norm is not finite")
    if repeat and not losses[-1] < losses[0]:
        fail(f"{arch}: the loss on a repeated batch did not fall: {losses}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def _leaf_gap(a, b) -> float:
    """max |a - b| over the largest |b| (each leaf its own scale)."""
    from repro_torch.training.optimizer import tree_leaves
    return max(float((x.cpu() - y.cpu()).abs().max())
               / max(float(y.abs().max()), 1e-30)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _grads(cfg, params, batch):
    """(loss, grads) of ``train_loss`` at ``params`` on their device."""
    from repro_torch.models import model as MDL
    from repro_torch.training import optimizer as OPT
    leaves = [p.detach().requires_grad_(True)
              for p in OPT.tree_leaves(params)]
    loss, _ = MDL.train_loss(cfg, OPT.tree_unflatten(params, leaves), batch)
    return float(loss.detach()), OPT.tree_unflatten(
        params, list(torch.autograd.grad(loss, leaves)))


def train_card_vs_cpu(smi: str, fns) -> None:
    """(b): reduced llama, zamba2, mixtral and xlstm, the same seeded
    params on both devices. Held: 3 train steps' losses within 1e-5
    relative; the first step's grads within 1e-4 of each leaf's largest
    magnitude (the CPU tests' bound against repro); AdamW's update on the
    card from the CPU's grads within 1e-6 of each leaf's scale. The params
    after 3 free-running steps are printed against 1e-5 of each leaf's
    scale, not held: AdamW turns grads at rounding level into updates of
    up to lr (ROADMAP C.11; repro and the port on one CPU differ by as
    much). The CPU side is held to repro by the CPU tests."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import TrainPipeline
    from repro_torch.models import model as MDL
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train import to_device
    ocfg = OPT.AdamWConfig(lr=1e-3, warmup_steps=1)
    for arch in TRAIN_REDUCED:
        cfg = replace(reduced(get_config(arch)), dtype="float32")
        p_cpu = MDL.init_params(cfg, seed=0, dtype=torch.float32,
                                device="cpu")
        pipe = TrainPipeline(cfg.vocab_size, 32, 4)
        batches = [pipe.batch(i) for i in range(3)]
        reset_counts(fns)
        p_gpu, _, l_gpu, _, _ = train_steps(cfg, to_dev(p_cpu, DEV),
                                            batches, opt_cfg=ocfg)
        _, g_gpu = _grads(cfg, to_dev(p_cpu, DEV),
                          to_device(batches[0], DEV))
        zero_launches(f"{arch} reduced", fns)
        _, g_cpu = _grads(cfg, p_cpu, to_device(batches[0], "cpu"))
        p_ref, _, l_cpu, _, _ = train_steps(cfg, p_cpu, batches,
                                            opt_cfg=ocfg, device="cpu")
        up_gpu = OPT.apply(ocfg, to_dev(p_cpu, DEV), to_dev(g_cpu, DEV),
                           OPT.init(to_dev(p_cpu, DEV)))[0]
        up_cpu = OPT.apply(ocfg, p_cpu, g_cpu, OPT.init(p_cpu))[0]
        lgap = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
        ggap, ugap = _leaf_gap(g_gpu, g_cpu), _leaf_gap(up_gpu, up_cpu)
        pgap = _leaf_gap(p_gpu, p_ref)
        print(f"[train] {arch} reduced, card vs CPU: losses of 3 steps "
              + " ".join(f"{x:.6f}" for x in l_gpu)
              + f" (max rel gap {lgap:.3e}, bound 1e-5); step 1 grads "
              f"{ggap:.3e} of each leaf's scale (bound 1e-4); AdamW update "
              f"from the same grads {ugap:.3e} (bound 1e-6); params after 3 "
              f"steps {pgap:.3e} of each leaf's scale (printed against "
              f"1e-5, not held: C.11)", flush=True)
        if lgap > 1e-5 or ggap > 1e-4 or ugap > 1e-6:
            fail(f"{arch}: the card's train steps disagree with the CPU's")


def train_microbatches(smi: str, fns) -> None:
    """(c): reduced llama on the card, 2 microbatches against 1: params
    within 5e-5 (``tests/test_system.py``'s bound)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import TrainPipeline
    from repro_torch.models import model as MDL
    from repro_torch.training import optimizer as OPT
    cfg = replace(reduced(get_config("llama3.2-1b")), dtype="float32")
    params = MDL.init_params(cfg, seed=2, dtype=torch.float32, device=DEV)
    ocfg = OPT.AdamWConfig(lr=1e-3, clip_norm=1e9, weight_decay=0.0)
    batch = [TrainPipeline(cfg.vocab_size, 8, 4).batch(0)]
    reset_counts(fns)
    outs = [train_steps(cfg, params, batch, opt_cfg=ocfg,
                        microbatches=mb)[0] for mb in (1, 2)]
    zero_launches("microbatches", fns)
    d = max(float((a - b).abs().max()) for a, b in
            zip(OPT.tree_leaves(outs[0]), OPT.tree_leaves(outs[1])))
    print(f"[train] microbatches 2 vs 1 on the card: params max gap "
          f"{d:.3e} (bound 5e-5)", flush=True)
    if d >= 5e-5:
        fail("microbatch accumulation disagrees with the full batch")


def train_restart(smi: str, fns) -> None:
    """(d): reduced llama on the card, 10 uninterrupted steps against 6
    with a checkpoint every 3, ``restore`` and 4 more, at
    ``tests/test_fault_tolerance.py``'s bounds (losses rtol 1e-6, params
    atol 1e-6). Deterministic algorithms make the embedding's backward
    (an accumulating index) repeatable."""
    import shutil
    import warnings
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import TrainPipeline
    from repro_torch.models import model as MDL
    from repro_torch.runtime import checkpoint as CK
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train import make_train_step, to_device
    cfg = replace(reduced(get_config("llama3.2-1b")), dtype="float32")
    params0 = MDL.init_params(cfg, seed=0, dtype=torch.float32, device=DEV)
    step_fn = make_train_step(cfg, MDL.DEFAULT_RT, OPT.AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=20))
    pipe = TrainPipeline(cfg.vocab_size, 16, 4)
    ck = TRAIN_DIR / "restart"
    shutil.rmtree(ck, ignore_errors=True)

    def run(params, opt, start, stop, every=None):
        losses = []
        for s in range(start, stop):
            params, opt, m = step_fn(params, opt, to_device(pipe.batch(s),
                                                            DEV))
            losses.append(float(m["loss"]))
            if every and (s + 1) % every == 0:
                CK.save(ck, s, {"params": params, "opt": opt})
        return params, opt, losses

    reset_counts(fns)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            p_ref, _, l_ref = run(params0, OPT.init(params0), 0, 10)
            run(params0, OPT.init(params0), 0, 6, every=3)
            latest = CK.latest_step(ck)
            state = CK.restore(ck, latest, {"params": params0,
                                            "opt": OPT.init(params0)})
            p_res, _, l_res = run(state["params"], state["opt"],
                                  latest + 1, 10)
        finally:
            torch.use_deterministic_algorithms(False)
    zero_launches("restart", fns)
    lgap = max(abs(a - b) / abs(b) for a, b in zip(l_res, l_ref[6:]))
    pgap = max(float((a - b).abs().max()) for a, b in
               zip(OPT.tree_leaves(p_res), OPT.tree_leaves(p_ref)))
    dev_ok = all(t.device.type == "cuda"
                 for t in OPT.tree_leaves(state["params"]))
    print(f"[train] crash and restart on the card: restored step {latest} "
          f"onto cuda={dev_ok}; losses 7-10 "
          + " ".join(f"{x:.6f}" for x in l_res)
          + f" max rel gap {lgap:.3e} (bound 1e-6), params max gap "
          f"{pgap:.3e} (bound 1e-6)", flush=True)
    if latest != 5 or not dev_ok or lgap > 1e-6 or pgap > 1e-6:
        fail("the restarted run does not resume the uninterrupted one")


def train_launch(smi: str, fns) -> None:
    """(f): ``launch.train`` in process at ``examples/train_100m.py``'s
    settings, 20 steps with checkpoints every 10, then a restart from step
    9's checkpoint (step 19's removed) that resumes and finishes."""
    import contextlib
    import io
    import shutil
    from repro_torch.launch import train as TRAIN
    ck = TRAIN_DIR / "ckpt_100m"
    shutil.rmtree(ck, ignore_errors=True)
    argv = ["--arch", "llama3.2-1b", "--steps", "20", "--seq", "256",
            "--batch", "8", "--d-model", "768", "--layers", "12", "--vocab",
            "8192", "--ckpt-dir", str(ck), "--ckpt-every", "10",
            "--log-every", "5"]
    reset_counts(fns)
    t = time.perf_counter()
    final = TRAIN.main(argv)
    first_s = time.perf_counter() - t
    shutil.rmtree(ck / "step_00000019")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        resumed = TRAIN.main(argv)
    print(buf.getvalue(), end="", flush=True)
    zero_launches("launch.train", fns)
    print(f"[train] launch.train: 20 steps in {first_s:.1f} s, final loss "
          f"{final:.4f}; the restart resumed at step 10, final loss "
          f"{resumed:.4f} (gap {abs(final - resumed):.3e}) | {smi}",
          flush=True)
    if "[train] restored step 9" not in buf.getvalue():
        fail("launch.train did not resume from its checkpoint")
    if not (np.isfinite(final) and np.isfinite(resumed)):
        fail("launch.train: a non-finite loss")


def train_serving_legacy(smi: str, launches: dict, fns) -> None:
    """(g): full-width llama3.2-1b, batched prefill at horizon 4: an
    engine with a host ``sample=`` greedy callable (the eager horizon, one
    logits readback a step) gives the graph path's greedy tokens;
    ``decode_graphs=True`` with ``sample=`` raises; int8 weight-only
    params (``core/quant.py``) keep the decode logits within
    ``tests/test_quant.py``'s bound of the fp32 ones."""
    from repro_torch.configs import get_config
    from repro_torch.core import quant as Q
    from repro_torch.core.paged_kv import PoolSpec
    from repro_torch.kernels.backend import KernelConfig
    from repro_torch.models import model as MDL
    from repro_torch.serving import DecodeEngine, EngineConfig
    cfg = replace(get_config("llama3.2-1b"), dtype="float32")
    params = MDL.init_params(cfg, seed=0, dtype=torch.float32, device=DEV)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n_tok))
               for n_tok in rng.integers(256, 1025, 8)]
    kw = dict(mode="batched", horizon=4, splits=4, n_req=8, chunk=32,
              use_kernels=None, prompts=prompts)
    calls = [0]

    def greedy(row):
        calls[0] += 1
        return int(np.argmax(row))
    runs = {}
    for way, extra in (("graphs", {}), ("sample=", dict(sample=greedy))):
        reset_counts(fns)
        out, m = serve(cfg, params, **kw, **extra)
        la = launch_counts(fns)
        want = expected_launches(cfg, m)
        if la != want or m["completed"] != 8:
            fail(f"sample= {way}: launches {la}, expected {want}")
        for k, v in la.items():
            launches[k] = launches.get(k, 0) + v
        runs[way] = (out, m)
        print(f"[train] (g) llama3.2-1b batched h4 {way}: graphs="
              f"{m['graphs']} decode steps {m['decode_steps']} device syncs "
              f"{m['device_syncs']} sample readbacks {m['sample_readbacks']} "
              f"decode tok/s {m['decode_tokens'] / m['decode_s']:.1f} TTFT "
              f"ms {m['ttft_mean_ms']:.1f} launches "
              f"{ {k: v for k, v in la.items() if v} } | {smi}", flush=True)
    if runs["sample="][1]["graphs"] or runs["sample="][1][
            "sample_readbacks"] != runs["sample="][1]["decode_steps"]:
        fail("sample=: not on the eager horizon, or readbacks uncounted")
    compare_tokens("llama3.2-1b sample= vs graphs", cfg, params, prompts,
                   runs["graphs"][0], runs["sample="][0],
                   ("graphs", "sample="))
    print(f"[train] (g) the callable ran {calls[0]} times", flush=True)
    try:
        DecodeEngine(cfg, EngineConfig(n_slots=8, page_size=16,
                                       n_pages=64, max_context=1280,
                                       decode_graphs=True), params,
                     device=DEV, sample=greedy)
    except ValueError as e:
        print(f"[train] (g) decode_graphs=True with sample= raises: {e}",
              flush=True)
    else:
        fail("decode_graphs=True with sample= did not raise")
    # int8 weight-only: the serving path's prefill and 8 decode steps on
    # K1 / K2, fp32 against int8 weights
    qparams = Q.quantize_params(params)
    B, S, page, steps = 4, 512, 16, 8
    maxp = (S + steps) // page + 2
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (B, S + steps)).astype(np.int32))
    bt = torch.arange(B * maxp, dtype=torch.int32).reshape(B, maxp)
    rt = MDL.Runtime(kernels=KernelConfig(n_splits=4))
    spec = PoolSpec(cfg.n_layers, B * maxp, page, cfg.n_kv_heads,
                    cfg.d_head, maxp, dtype="float32")
    outs, step_ms = {}, {}
    from repro_torch.kernels.ops import write_targets
    for name, p in (("fp32", params), ("int8", qparams)):
        st = MDL.init_decode_state(cfg, spec, B, device=DEV)
        with torch.no_grad():
            lg, st = MDL.prefill(cfg, p, st, toks[:, :S].to(DEV),
                                 bt.to(DEV), rt=rt)
            got = [lg]
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            for t in range(S, S + steps):
                ctx = torch.full((B,), t + 1, dtype=torch.int32, device=DEV)
                npage, noff = write_targets(
                    bt.to(DEV), ctx, torch.ones(B, dtype=torch.bool,
                                                device=DEV),
                    page_size=page, n_pages=B * maxp)
                if t == S + steps - 1:
                    ev[0].record()
                lg, st = MDL.decode_step(cfg, p, st, toks[:, t].to(DEV),
                                         bt.to(DEV), ctx, npage, noff, rt=rt)
                got.append(lg)
            ev[1].record()
            torch.cuda.synchronize()
        outs[name] = torch.stack(got).cpu().numpy()
        step_ms[name] = ev[0].elapsed_time(ev[1])
        del st
    fp, qq = outs["fp32"], outs["int8"]
    gap, spread = float(np.abs(qq - fp).max()), float(fp.max() - fp.min())
    agree = float((fp.argmax(-1) == qq.argmax(-1)).mean())
    print(f"[train] (g) int8 weight-only llama3.2-1b: "
          f"{Q.quantized_bytes(qparams) / 2**30:.2f} GiB against "
          f"{Q.quantized_bytes(params) / 2**30:.2f}; prefill + {steps} "
          f"decode logits max gap {gap:.4f} = {gap / spread:.4f} of their "
          f"spread (bound 0.12), greedy agreement {agree:.3f} (bound "
          f"0.75); one decode step fp32 {step_ms['fp32']:.2f} ms, int8 "
          f"{step_ms['int8']:.2f} ms (dequantized per use) | {smi}",
          flush=True)
    if gap >= 0.12 * spread or agree < 0.75:
        fail("int8 decode logits are outside test_quant's bound")
    del params, qparams
    gc.collect()
    torch.cuda.empty_cache()


def phase_train(smi: str, launches: dict) -> None:
    """Phase 14: training on the card, (a)-(g)."""
    TRAIN_DIR.mkdir(parents=True, exist_ok=True)
    fns = _kernel_fns()
    t0 = time.perf_counter()
    steps = (("a", lambda: train_whole("llama3.2-1b", smi, fns, B=8, S=512,
                                       steps=8, repeat=True)),
             ("b", lambda: train_card_vs_cpu(smi, fns)),
             ("c", lambda: train_microbatches(smi, fns)),
             ("d", lambda: train_restart(smi, fns)),
             ("e", lambda: train_whole("zamba2-1.2b", smi, fns, B=4, S=512,
                                       steps=3, repeat=False)),
             ("f", lambda: train_launch(smi, fns)),
             ("g", lambda: train_serving_legacy(smi, launches, fns)))
    for label, fn in steps:
        t = time.perf_counter()
        fn()
        print(f"[train] ({label}) in {time.perf_counter() - t:.1f} s",
              flush=True)
    print(f"[train] phase 14 in {time.perf_counter() - t0:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# 15. the multi-device serving paths on a single-process mesh
# ---------------------------------------------------------------------------

LONG_CTX = 524288               # (a): long_500k's context
LONG_SPLITS = 16                # (a): K1 splits a shard's table into
SHARD_SPLITS = 4                # (b): the same in the batched case


def _sharded_params(arch: str, layers: int | None = None):
    from repro_torch.configs import get_config
    from repro_torch.models import model as MDL
    cfg = replace(get_config(arch), dtype="float32")
    if layers is not None:
        cfg = replace(cfg, n_layers=layers)
    return cfg, MDL.init_params(cfg, seed=0, dtype=torch.float32, device=DEV)


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def _greedy_check(label, cfg, lg_a, lg_b, tok_a) -> float:
    """The greedy token of logits ``lg_b`` (the reference, fed ``tok_a``'s
    history) must be ``tok_a`` unless its top-2 gap is under ``TIE_GAP``
    (ROADMAP C.3). Returns max |lg_a - lg_b|."""
    V = cfg.vocab_size
    b = lg_b[..., :V]
    tb = b.argmax(-1)
    diff = tb != tok_a
    if bool(diff.any()):
        top = b.topk(2, dim=-1).values
        gaps = (top[..., 0] - top[..., 1])[diff]
        print(f"[sharded] {label}: greedy tokens differ in "
              f"{int(diff.sum())} rows, reference top-2 gaps "
              f"{gaps.tolist()}", flush=True)
        if bool((gaps >= TIE_GAP).any()):
            fail(f"{label}: greedy tokens differ from the reference")
    return float((lg_a[..., :V] - b).abs().max())


def _check_path(label, la, want, launches) -> None:
    print(f"[sharded] {label} launches: " + " ".join(
        f"{k}={la[k]} (expected {want.get(k, 0)})" for k in la
        if want.get(k, 0) or la[k]), flush=True)
    if any(la[k] != want.get(k, 0) for k in la):
        fail(f"{label}: kernel launches {la} do not match {want}")
    for k, v in la.items():
        launches[k] = launches.get(k, 0) + v


def _logit_gap(lg_a, lg_b) -> float:
    """max |lg_a - lg_b| over the largest |lg_b|."""
    return float((lg_a - lg_b).abs().max()) / float(lg_b.abs().max())


def _tp_slices(label, plan, params, rt) -> str:
    """The serve plan's cut of ``params`` (``make_decode_step``'s shard
    holds these slices): fails unless it cuts something and the runtime
    runs TP over ``model``; returns a note of how much."""
    from repro_torch.distributed.sharding import _leaves
    specs = plan.spec_list(params, mode="serve")
    n_cut = sum(any(e is not None for e in sp) for sp in specs)
    whole = sum(t.numel() * t.element_size() for _, t, _ in _leaves(params))
    held = sum(t.numel() * t.element_size() // (
        plan.tp if plan.tp_axis in sp else 1)
        for (_, t, _), sp in zip(_leaves(params), specs))
    if not n_cut or rt.tp_axis != plan.tp_axis:
        fail(f"{label}: the decode shard does not run TP on its slices")
    return (f"{n_cut} of {len(specs)} weight leaves cut over model, "
            f"{held / 1e9:.2f} of {whole / 1e9:.2f} GB a shard")


def sharded_long(smi: str, launches: dict, fns) -> None:
    """(a) long_500k: one request over all 8 shards of a (data 2, model 4)
    mesh, gemma3-27b at full width, its first 6 layers (5 local with the
    1024-token window, 1 global), a context of ``LONG_CTX`` tokens in
    pages of 256 striped over the mesh and merged over both axes. The pool
    is seeded K/V (its ``LONG_CTX - 4`` tokens), then 4 greedy decode
    steps through ``sharding.make_decode_step``: the dense layers as
    Megatron TP over ``model`` on each shard's serve slices (the request
    replicated over ``data``), K1 on each shard's local table,
    ``windowed_slice`` on the local layers (``cond_window`` 1024). Held to
    the unsharded step (K1 at ``n_splits`` 64) on the same pool, fed the
    same tokens: logits within 1e-5 of their scale, greedy tokens
    identical (C.3)."""
    from repro_torch.configs import SHAPES, ParallelConfig
    from repro_torch.core.allocator import PageAllocator
    from repro_torch.core.paged_kv import PoolSpec
    from repro_torch.distributed.mesh import LocalMesh
    from repro_torch.distributed.sharding import make_decode_step, make_plan
    from repro_torch.kernels.backend import KernelConfig
    from repro_torch.models import model as MDL
    cfg, params = _sharded_params("gemma3-27b", layers=6)
    page, steps, n_shards = 256, 4, 8
    n_pages = LONG_CTX // page
    P_loc = n_pages // n_shards
    mesh = LocalMesh((2, 4), ("data", "model"))
    parallel = ParallelConfig(page_size=page, kernel_splits=LONG_SPLITS)
    plan = make_plan(mesh, parallel, SHAPES["long_500k"])
    spec = PoolSpec(cfg.n_layers, n_pages, page, cfg.n_kv_heads, cfg.d_head,
                    n_pages, dtype="float32")
    state = MDL.init_decode_state(cfg, spec, 1, device=DEV)
    g = torch.Generator(device=DEV)
    g.manual_seed(15)
    for name in ("k", "v"):
        for i in range(cfg.n_layers):
            state["pool"][name][i].normal_(generator=g)
    alloc = PageAllocator(n_pages, n_shards, page, policy="striped")
    alloc.admit(0, LONG_CTX)
    bt = torch.tensor(alloc.block_table(0, n_pages)[None], dtype=torch.int32,
                      device=DEV)
    # the resident form a ProcessMesh rank takes (on this LocalMesh the
    # global tensors themselves: shard and gather are the identity)
    p_spec, s_spec = (plan.param_specs(params, mode="serve"),
                      plan.state_specs(state))
    step = make_decode_step(cfg, plan, parallel, spec, specs=p_spec)
    p_loc, state = plan.shard(params, p_spec), plan.shard(state, s_spec)
    if step.rt.cond_window != cfg.sliding_window or \
            plan.itpp_spec(page).merge_axes != ("data", "model"):
        fail("long_500k: the plan did not set cond_window / the pod merge")
    cut = _tp_slices("(a)", plan, params, step.rt)
    start = LONG_CTX - steps
    tok = torch.tensor([7], dtype=torch.int32, device=DEV)
    toks, lgs, ms = [], [], []
    _free()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fns)

    def step_args(j):
        pos = start + j
        return (torch.tensor([pos + 1], dtype=torch.int32, device=DEV),
                bt[:, pos // page].contiguous(),
                torch.tensor([pos % page], dtype=torch.int32, device=DEV))
    for j in range(steps):
        ctx, npage, noff = step_args(j)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, state = step(p_loc, state, {"tokens": tok, "bt": bt, "ctx": ctx,
                                        "npage": npage, "noff": noff})
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        lgs.append(lg)
        toks.append(tok)
        tok = lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
    state = plan.gather(state, s_spec)
    la = launch_counts(fns)
    windowed = fns["paged_attention"].launches_windowed
    n_local = sum(1 for k in cfg.block_kinds() if k == "local")
    want = {"paged_attention": cfg.n_layers * n_shards * steps}
    _check_path("(a) long_500k", la, want, launches)
    if windowed != n_local * n_shards * steps:
        fail(f"(a): {windowed} windowed_slice launches, expected "
             f"{n_local * n_shards * steps}")
    launches["paged_attention windowed"] = \
        launches.get("paged_attention windowed", 0) + windowed
    peak = torch.cuda.max_memory_allocated()
    # the reference: the unsharded step, K1 over the whole table, fed the
    # same tokens
    rt_ref = MDL.Runtime(kernels=KernelConfig(n_splits=64))
    gap, err, ms_ref = 0.0, 0.0, []
    for j in range(steps):
        ctx, npage, noff = step_args(j)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, state = MDL.decode_step(cfg, params, state, toks[j], bt, ctx,
                                    npage, noff, rt=rt_ref)
        torch.cuda.synchronize()
        ms_ref.append(1e3 * (time.perf_counter() - t))
        nxt = toks[j + 1] if j + 1 < steps else \
            lgs[j][:, :cfg.vocab_size].argmax(-1)
        gap = max(gap, _greedy_check("(a)", cfg, lgs[j], lg, nxt))
        err = max(err, _logit_gap(lgs[j], lg))
    if not err <= 1e-5:
        fail(f"(a): logits differ from the unsharded step by {err:.3e} of "
             "scale (bound 1e-5)")
    # K1 on the global layer: the 8 shards' launches against one launch
    # over the whole table, and the byte bound of the layer's K/V
    from repro_torch.kernels.paged_attention import paged_attention_partials
    gl = cfg.block_kinds().index("attn")
    pk, pv = state["pool"]["k"][gl], state["pool"]["v"][gl]
    q = torch.randn((1, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                     cfg.d_head), generator=g, device=DEV)
    ctx = torch.tensor([LONG_CTX], dtype=torch.int32, device=DEV)
    locs = [torch.where((bt >= s * P_loc) & (bt < (s + 1) * P_loc),
                        bt - s * P_loc, -1).to(torch.int32)
            for s in range(n_shards)]
    views = [(pk.narrow(0, s * P_loc, P_loc), pv.narrow(0, s * P_loc, P_loc))
             for s in range(n_shards)]

    def sharded_k1():
        for (k, v), b in zip(views, locs):
            paged_attention_partials(q, k, v, b, ctx, n_splits=LONG_SPLITS)
    k1_ms = cuda_ms(sharded_k1, iters=5, warmup=1)
    one_ms = cuda_ms(lambda: paged_attention_partials(
        q, pk, pv, bt, ctx, n_splits=64), iters=5, warmup=1)
    kv_bytes = 2 * LONG_CTX * cfg.n_kv_heads * cfg.d_head * 4
    bound = kv_bytes / HBM_BYTES_S * 1e3
    print(f"[sharded] (a) long_500k gemma3-27b {cfg.n_layers} layers "
          f"(5 local w{cfg.sliding_window} + 1 global) ctx {LONG_CTX} page "
          f"{page} mesh (data 2, model 4) striped, merge over both, TP over "
          f"model ({cut}): step ms "
          + " ".join(f"{x:.2f}" for x in ms) + " (unsharded K1 n_splits 64: "
          + " ".join(f"{x:.2f}" for x in ms_ref) + f"); logits {err:.3e} of "
          f"scale (bound 1e-5), max logit gap {gap:.3e}; K1 launches "
          f"{la['paged_attention']} ({windowed} windowed_slice); global "
          f"layer K1 8 shards x n_splits {LONG_SPLITS} {k1_ms:.3f} ms, one "
          f"launch n_splits 64 {one_ms:.3f} ms, bound {bound:.3f} ms "
          f"({kv_bytes / 1e9:.2f} GB at 3.35 TB/s); peak device GB "
          f"{peak / 1e9:.2f} | {smi}", flush=True)
    del params, state, views, pk, pv
    _free()


def sharded_batched(smi: str, launches: dict, fns, params) -> None:
    """(b) decode_32k's layout at smoke scale: llama3.2-1b whole, 8 rows
    over a (data 2, model 4) mesh, ``row_affine`` (2 rows) with
    ``blocked_chunk``, prompts of 256-1024 tokens padded to 1024. The
    prefill is repro's prefill cell (``sharding.make_prefill_step``:
    ``sp``, FSDP weights; a shard's 4 rows x 256 tokens, K2 at its
    ``q_offset`` against the rows' gathered 1024 keys, the pages it owns
    written), its logits and pool pages within 1e-4 of scale of the
    unsharded kernel prefill's; then 32 greedy decode steps through the
    decode step (``sharding.make_decode_step``: TP over ``model`` on the
    shards' serve slices, each data row's 4 rows, ITPP merged over
    ``model``), tokens equal to the unsharded K1 step fed the same tokens
    (C.3), logits within 1e-5 of their scale."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.mesh import LocalMesh
    from repro_torch.distributed.sharding import (make_decode_step,
                                                  make_prefill_step)
    from repro_torch.kernels.backend import KernelConfig
    from repro_torch.models import model as MDL
    cfg = replace(get_config("llama3.2-1b"), dtype="float32")
    B, S, page, steps, n_shards = 8, 1024, 16, 32, 8
    case = _mesh_serve_case(cfg, LocalMesh((2, 4), ("data", "model")), steps)
    parallel, spec, lens = case["parallel"], case["spec"], case["lens"]
    pre_plan, plan, step_args = case["pre_plan"], case["plan"], \
        case["step_args"]
    batch = case["batch"]
    bt, tokens, valid = batch["bt"], batch["tokens"], batch["valid_len"]
    n_pages = spec.n_pages
    # the resident form a ProcessMesh rank takes (phase 17); on this
    # LocalMesh shard and gather are the identity
    pt_spec = pre_plan.param_specs(params, mode="train")
    ps_spec = plan.param_specs(params, mode="serve")
    pre_step = make_prefill_step(cfg, pre_plan, parallel, spec,
                                 specs=pt_spec)
    step = make_decode_step(cfg, plan, parallel, spec, specs=ps_spec)
    cut = _tp_slices("(b)", plan, params, step.rt)
    if pre_plan.itpp_spec(page) != plan.itpp_spec(page) or \
            plan.itpp_spec(page).merge_axes != ("model",):
        fail("(b): the prefill and decode plans do not share the pool's "
             "layout / the row merge")
    V = cfg.vocab_size
    # the unsharded runtime's prefill (write_prefill's pool) comes first:
    # the sharded pool is held to it before its decode steps write
    rt_u = MDL.Runtime(kernels=KernelConfig(n_splits=SHARD_SPLITS))
    state_u = MDL.init_decode_state(cfg, spec, B, device=DEV)
    torch.cuda.synchronize()
    t = time.perf_counter()
    lg0_u, _ = MDL.prefill(cfg, params, state_u, tokens, bt,
                           last_idx=valid - 1, valid_len=valid, rt=rt_u)
    torch.cuda.synchronize()
    pre_ms_u = 1e3 * (time.perf_counter() - t)
    state = MDL.init_decode_state(cfg, spec, B, device=DEV)
    s_spec = plan.state_specs(state)
    state = plan.shard(state, s_spec)
    _free()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fns)
    torch.cuda.synchronize()
    t = time.perf_counter()
    lg0, state = pre_step(pre_plan.shard(params, pt_spec), state, batch)
    torch.cuda.synchronize()
    pre_ms = 1e3 * (time.perf_counter() - t)
    pgap = max(float((state["pool"][n][:, :n_pages]
                      - state_u["pool"][n][:, :n_pages]).abs().max())
               / float(state_u["pool"][n].abs().max()) for n in ("k", "v"))
    lgap = float((lg0[:, :V] - lg0_u[:, :V]).abs().max()) \
        / float(lg0_u[:, :V].abs().max())
    if pgap > 1e-4 or lgap > 1e-4:
        fail(f"(b): the sharded prefill's logits ({lgap:.3e} of scale) or "
             f"pool pages ({pgap:.3e}) differ from the unsharded prefill's "
             "by more than 1e-4")
    tok = lg0[:, :V].argmax(-1).to(torch.int32)
    toks, lgs, ms = [tok], [], []
    p_loc = plan.shard(params, ps_spec)
    for j in range(steps):
        ctx, npage, noff = step_args(j)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, state = step(p_loc, state, {"tokens": tok, "bt": bt, "ctx": ctx,
                                        "npage": npage, "noff": noff})
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        lgs.append(lg)
        tok = lg[:, :V].argmax(-1).to(torch.int32)
        toks.append(tok)
    la = launch_counts(fns)
    want = {"flash_attention": cfg.n_layers * n_shards,
            "paged_attention": cfg.n_layers * n_shards * steps}
    _check_path("(b) batched", la, want, launches)
    peak = torch.cuda.max_memory_allocated()
    # the unsharded runtime's decode, K1 over whole tables, fed the tokens
    gap = _greedy_check("(b) prefill", cfg, lg0, lg0_u, toks[0])
    err, ms_u = 0.0, []
    for j in range(steps):
        ctx, npage, noff = step_args(j)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, _ = MDL.decode_step(cfg, params, state_u, toks[j], bt, ctx,
                                npage, noff, rt=rt_u)
        torch.cuda.synchronize()
        ms_u.append(1e3 * (time.perf_counter() - t))
        gap = max(gap, _greedy_check("(b)", cfg, lgs[j], lg, toks[j + 1]))
        err = max(err, _logit_gap(lgs[j], lg))
    if not err <= 1e-5:
        fail(f"(b): decode logits differ from the unsharded step by "
             f"{err:.3e} of scale (bound 1e-5)")
    warm = np.median(ms[1:])
    print(f"[sharded] (b) batched llama3.2-1b {cfg.n_layers} layers, 8 rows "
          f"(prompts {int(lens.min())}-{int(lens.max())}) over (data 2, "
          f"model 4) row_affine + blocked_chunk {S // 4 // page}: prefill ms "
          f"{pre_ms:.1f} (make_prefill_step, sp: logits {lgap:.3e}, pool "
          f"pages {pgap:.3e} of scale from the unsharded prefill's, bound "
          f"1e-4; unsharded {pre_ms_u:.1f}), decode step ms "
          f"median {warm:.2f} (make_decode_step, TP over model: {cut}; "
          f"unsharded K1 {np.median(ms_u[1:]):.2f}); tokens identical over "
          f"{steps} steps, logits {err:.3e} of scale (bound 1e-5), max "
          f"logit gap {gap:.3e}; "
          f"K1 launches {la['paged_attention']}, K2 "
          f"{la['flash_attention']}; peak device GB {peak / 1e9:.2f} | {smi}",
          flush=True)
    del state, state_u
    _free()


def sharded_moe(smi: str, launches: dict, fns) -> None:
    """(c) ``moe_ep``: one mixtral-8x22b MoE layer at full width (8
    experts, d 6144, ff 16384) as 8 virtual experts on 8 shards (mesh
    (data 1, model 8), the plan's expert-parallel runtime), capacity
    factor 8 (dropless), 8 x 64 tokens: within 2e-5 of scale of
    ``moe_local``; its aux (the shards' mean balance term) within 1e-6 of
    the mean of each shard's balance term computed here from the router
    logits."""
    from repro_torch.configs import ParallelConfig, ShapeConfig, get_config
    from repro_torch.distributed import mesh as M
    from repro_torch.distributed.sharding import make_plan
    from repro_torch.models import moe as MOE
    cfg = replace(get_config("mixtral-8x22b"), dtype="float32",
                  capacity_factor=8.0)
    g = torch.Generator(device=DEV)
    g.manual_seed(15)

    def normal(shape, scale):
        return torch.randn(shape, generator=g, device=DEV) * scale
    p = MOE.init_moe(cfg, normal, n_virtual=8)
    x = torch.randn((8, 64, cfg.d_model), generator=g, device=DEV)
    parallel = ParallelConfig(remat=False)
    plan = make_plan(M.LocalMesh((1, 8), ("data", "model")), parallel,
                     ShapeConfig("m", "prefill", 64, 8), train_layout="sp")
    rt = plan.make_runtime(cfg, parallel, mode="prefill")

    def body(pw, x_loc):            # a prefill shard's MoE (its 8 tokens)
        y, aux = rt.moe_apply(pw, cfg, x_loc, with_aux=True)
        return y, M.pmean(aux, ("data", "model"))
    act = M.P("data", "model")
    moe = M.shard_map(body, plan.mesh, in_specs=(
        {k: None if k == "router" else M.P("model") for k in p}, act),
        out_specs=(act, None))
    _free()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fns)
    y, aux = moe(p, x)
    torch.cuda.synchronize()
    _check_path("(c) moe_ep", launch_counts(fns), {}, launches)
    peak = torch.cuda.max_memory_allocated()
    y_ref, aux_all = MOE.moe_local(p, cfg, x, with_aux=True)
    err = float((y - y_ref).abs().max()) / float(y_ref.abs().max())
    # each shard's balance term from its tokens' router logits, apart from
    # models/moe.py: E * sum_e (mean probability of e) * (top-1 share of e)
    E = cfg.n_experts
    terms = []
    for s in range(8):
        xs = x[:, s * 8:(s + 1) * 8].reshape(-1, cfg.d_model)
        probs = torch.softmax(xs @ p["router"], dim=-1)
        share = torch.bincount(probs.argmax(-1), minlength=E) / xs.shape[0]
        terms.append(E * (probs.mean(0) * share).sum())
    aux_plain = torch.stack(terms).sum(0) / 8
    if not err <= 2e-5 or abs(float(aux) - float(aux_plain)) > \
            1e-6 * abs(float(aux_plain)):
        fail(f"(c): moe_ep err {err:.3e} of scale (bound 2e-5), aux "
             f"{float(aux)} vs {float(aux_plain)}")
    ep_ms = cuda_ms(lambda: moe(p, x), iters=3, warmup=1)
    local_ms = cuda_ms(lambda: MOE.moe_local(p, cfg, x), iters=3, warmup=1)
    print(f"[sharded] (c) moe_ep mixtral-8x22b layer (8 experts d "
          f"{cfg.d_model} ff {cfg.d_ff}, 8 virtual on 8 shards, dropless) "
          f"8 x 64 tokens: err {err:.3e} of scale, aux {float(aux):.6f} "
          f"(plain shard mean {float(aux_plain):.6f}; moe_local's over all "
          f"tokens {float(aux_all):.6f}); ms {ep_ms:.2f} (moe_local "
          f"{local_ms:.2f}); peak device GB {peak / 1e9:.2f} | {smi}",
          flush=True)
    del p, x, y, y_ref
    _free()


def sharded_pipeline(smi: str, launches: dict, fns, params) -> None:
    """(d) pipeline decode: llama3.2-1b whole on a (pod 2, data 2, model 2)
    mesh, 2 stages, 2 microbatches, B 4, 256 prefilled tokens (K2), 16
    decode steps teacher-forced, each stage's layers as Megatron TP over
    ``model`` on the shards' serve slices (the decode runtime of
    ``sharding.make_decode_step``), a microbatch's rows over ``data``:
    logits within 1e-5 of their scale of the unsharded step's fed the same
    tokens (greedy tokens identical, C.3) and within 5e-3 (the bound of
    ``tests/test_distributed.py``) of the port's full-sequence forward."""
    from repro_torch.configs import ParallelConfig, ShapeConfig, get_config
    from repro_torch.core.allocator import PageAllocator
    from repro_torch.core.paged_kv import PoolSpec
    from repro_torch.distributed.mesh import LocalMesh
    from repro_torch.distributed.pipeline import (make_pp_decode_step,
                                                  stage_specs)
    from repro_torch.distributed.sharding import make_plan
    from repro_torch.kernels.backend import KernelConfig
    from repro_torch.models import model as MDL
    cfg = replace(get_config("llama3.2-1b"), dtype="float32")
    B, S_pre, steps, page, mbs = 4, 256, 16, 16, 2
    S = S_pre + steps
    maxp = S // page + 1
    n_pages = 4 * 24
    mesh = LocalMesh((2, 2, 2), ("pod", "data", "model"))
    parallel = ParallelConfig(page_size=page, remat=False)
    plan = make_plan(mesh, parallel, ShapeConfig("d", "decode", S, B),
                     pod_mode="pp")
    spec = PoolSpec(cfg.n_layers, n_pages, page, cfg.n_kv_heads, cfg.d_head,
                    maxp, dtype="float32")
    alloc = PageAllocator(n_pages, 4, page, policy="row_affine", n_rows=2)
    for b in range(B):
        alloc.admit(b, S, row=b % 2)
    bt = torch.tensor(np.stack([alloc.block_table(b, maxp)
                                for b in range(B)]), dtype=torch.int32,
                      device=DEV)
    rng = np.random.default_rng(16)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)), device=DEV)
    state = MDL.init_decode_state(cfg, spec, B, device=DEV)
    p_spec = stage_specs(plan, plan.param_specs(params, mode="serve"))
    step = make_pp_decode_step(cfg, plan, parallel, spec, n_stages=2,
                               microbatches=mbs, specs=p_spec)
    cut = _tp_slices("(d)", plan, params, plan.make_runtime(
        cfg, parallel, pool_spec=spec, mode="decode"))
    _free()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fns)
    MDL.prefill(cfg, params, state, toks[:, :S_pre], bt,
                rt=MDL.Runtime(kernels=KernelConfig()))
    state_u = {"pool": {k: v.clone() for k, v in state["pool"].items()}}
    # resident (the identity on this LocalMesh, as in (a) and (b))
    s_spec = plan.state_specs(state)
    p_loc, state = plan.shard(params, p_spec), plan.shard(state, s_spec)
    lgs, ms = [], []
    for t_ in range(S_pre, S):
        batch = {"tokens": toks[:, t_], "bt": bt,
                 "ctx": torch.full((B,), t_ + 1, dtype=torch.int32,
                                   device=DEV),
                 "npage": bt[:, t_ // page].contiguous(),
                 "noff": torch.full((B,), t_ % page, dtype=torch.int32,
                                    device=DEV)}
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, state = step(p_loc, state, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        lgs.append(lg)
    state = plan.gather(state, s_spec)
    la = launch_counts(fns)
    want = {"flash_attention": cfg.n_layers,
            "paged_attention": steps * mbs * cfg.n_layers * 4}
    _check_path("(d) pipeline", la, want, launches)
    peak = torch.cuda.max_memory_allocated()
    # the unsharded step on a copy of the prefilled pool, the same tokens
    rt_u, err, tgap = MDL.Runtime(kernels=KernelConfig()), 0.0, 0.0
    for j, t_ in enumerate(range(S_pre, S)):
        lg, _ = MDL.decode_step(
            cfg, params, state_u, toks[:, t_], bt,
            torch.full((B,), t_ + 1, dtype=torch.int32, device=DEV),
            bt[:, t_ // page].contiguous(),
            torch.full((B,), t_ % page, dtype=torch.int32, device=DEV),
            rt=rt_u)
        err = max(err, _logit_gap(lgs[j], lg))
        tgap = max(tgap, _greedy_check("(d)", cfg, lgs[j], lg,
                                       lgs[j][:, :cfg.vocab_size].argmax(-1)))
    if not err <= 1e-5:
        fail(f"(d): pipeline logits differ from the unsharded step by "
             f"{err:.3e} of scale (bound 1e-5)")
    del state_u
    ref, _ = MDL.forward(cfg, params, toks)
    gap = max(float((lg - ref[:, S_pre + j]).abs().max())
              for j, lg in enumerate(lgs))
    if not gap < 5e-3:
        fail(f"(d): pipeline logits differ from forward by {gap:.3e}")
    print(f"[sharded] (d) pipeline llama3.2-1b {cfg.n_layers} layers, mesh "
          f"(pod 2, data 2, model 2), 2 stages x {cfg.n_layers // 2} layers, "
          f"{mbs} microbatches, B {B}, {S_pre} prefilled + {steps} decode "
          f"steps, TP over model ({cut}): logits {err:.3e} of scale from "
          f"the unsharded step's (bound 1e-5; max gap {tgap:.3e}), max "
          f"|logits - forward| {gap:.3e} (bound 5e-3); step ms "
          f"median {np.median(ms[1:]):.2f}; K1 launches "
          f"{la['paged_attention']}, K2 {la['flash_attention']}; peak device "
          f"GB {peak / 1e9:.2f} | {smi}", flush=True)
    del state, ref
    _free()


def phase_sharded(smi: str, launches: dict) -> None:
    """Phase 15: the multi-device serving paths on a single-process
    8-shard mesh, (a)-(d)."""
    fns = _kernel_fns()
    fns["paged_attention"].launches_windowed = 0
    t0 = time.perf_counter()
    t = time.perf_counter()
    sharded_long(smi, launches, fns)
    print(f"[sharded] (a) in {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    _, params = _sharded_params("llama3.2-1b")
    sharded_batched(smi, launches, fns, params)
    print(f"[sharded] (b) in {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    sharded_pipeline(smi, launches, fns, params)
    print(f"[sharded] (d) in {time.perf_counter() - t:.1f} s", flush=True)
    del params
    _free()
    t = time.perf_counter()
    sharded_moe(smi, launches, fns)
    print(f"[sharded] (c) in {time.perf_counter() - t:.1f} s", flush=True)
    print(f"[sharded] phase 15 in {time.perf_counter() - t0:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# 16. the sharded train step on a single-process mesh, and the dry-run
# ---------------------------------------------------------------------------

TRAIN_OPT = dict(lr=1e-3, warmup_steps=1)


def _first_moments(opt) -> list:
    """AdamW's first moments after one step, on the host: (1 - b1) times
    the clipped grads."""
    from repro_torch.training.optimizer import tree_leaves
    return [m.detach().cpu() for m in tree_leaves(opt["m"])]


def _moment_gap(a: list, b: list) -> float:
    """max |a - b| over the largest |b|, each leaf its own scale."""
    return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(a, b))


def mesh_train(label: str, cfg, make_params, batches, mesh, smi: str,
               fns, *, ref_rt, want_layout: str, aux_ref=None) -> None:
    """One of (a)-(c): ``batches[0]`` through the unsharded step
    (``ref_rt``: phase 14's, or for a MoE the single-device step whose
    aux is the shards' mean, ``aux_ref(params)``) for the reference, then
    ``len(batches)`` steps of ``make_train_step`` on ``mesh`` in the
    plan's layout, from ``make_params()`` (freed once step 1 has made
    new ones). Held: the first step's loss and grad norm within 1e-5
    relative, its first moments (the clipped grads) within 1e-4 of each
    leaf's scale (phase 14's card-vs-CPU bounds); the sharded steps
    launch no kernel."""
    from repro_torch.configs import ParallelConfig, ShapeConfig
    from repro_torch.distributed.sharding import make_plan
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train import make_train_step, to_device
    ocfg = OPT.AdamWConfig(**TRAIN_OPT)
    B, S = batches[0]["tokens"].shape
    p = make_params()
    out = train_steps(cfg, p, batches[:1], rt=ref_rt, opt_cfg=ocfg)
    m_ref, l_ref, g_ref, ms_ref = _first_moments(out[1]), *out[2:]
    del out
    _free()
    want_aux = aux_ref(p) if aux_ref is not None else None
    plan = make_plan(mesh, ParallelConfig(), ShapeConfig("t", "train", S, B))
    if plan.train_layout != want_layout:
        fail(f"{label}: the plan chose {plan.train_layout}, not "
             f"{want_layout}")
    rt = plan.make_runtime(cfg, ParallelConfig(), mode="train")
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fns)
    # resident params and moments (on this LocalMesh the global ones;
    # phase 17 runs the same on a ProcessMesh)
    spec = plan.param_specs(p, mode="train")
    o_spec = {"m": spec, "v": spec, "step": None}
    step = make_train_step(cfg, rt, ocfg, specs=spec)
    p = plan.shard(p, spec)
    opt = OPT.init(p)
    losses, gnorms, ms, aux = [], [], [], []
    for i, b in enumerate(batches):
        batch = to_device(b, DEV)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        p, opt, m = step(p, opt, batch)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if "aux" in m:
            aux.append(float(m["aux"]))
        if i == 0:
            m_mesh = _first_moments(plan.gather(opt, o_spec))
    peak = torch.cuda.max_memory_allocated()
    zero_launches(label, fns)
    lgap = abs(losses[0] - l_ref[0]) / abs(l_ref[0])
    ggap = abs(gnorms[0] - g_ref[0]) / abs(g_ref[0])
    mgap = _moment_gap(m_mesh, m_ref)
    warm = ms[1:] or ms
    tag = f"{label} {cfg.name} {cfg.n_layers} layers d={cfg.d_model}"
    print(f"[train-sharded] {tag}: {plan.train_layout} on {mesh!r}, B={B} "
          f"S={S} remat; unsharded step ms {ms_ref[0]:.1f}; sharded step ms "
          + " ".join(f"{x:.1f}" for x in ms)
          + f"; tokens/s {B * S / (np.mean(warm) / 1e3):.0f} (steps 2..); "
          f"peak device GB {peak / 1e9:.2f} | {smi}", flush=True)
    print(f"[train-sharded] {tag}: step 1 loss {losses[0]:.6f} (unsharded "
          f"{l_ref[0]:.6f}, rel gap {lgap:.3e}, bound 1e-5), grad norm "
          f"{gnorms[0]:.6f} ({ggap:.3e}, bound 1e-5), first moments "
          f"{mgap:.3e} of each leaf's scale (bound 1e-4); losses "
          + " ".join(f"{x:.4f}" for x in losses), flush=True)
    if lgap > 1e-5 or ggap > 1e-5 or mgap > 1e-4:
        fail(f"{label}: the sharded step disagrees with the unsharded one")
    if want_aux is not None:
        agap = abs(aux[0] - want_aux) / abs(want_aux)
        print(f"[train-sharded] {tag}: aux {aux[0]:.6f} = the shards' mean "
              f"of their balance terms {want_aux:.6f} (rel gap {agap:.3e}, "
              "bound 1e-5)", flush=True)
        if agap > 1e-5:
            fail(f"{label}: the aux is not the shards' mean")
    if not np.isfinite(losses).all():
        fail(f"{label}: a loss is not finite")
    del p, opt
    _free()


def train_sharded_dense(smi: str, fns) -> None:
    """(a) llama3.2-1b whole, fp32, B 8 x S 512 in ``fsdp`` on (data 2,
    model 4), 3 steps; (b) the same model in ``sp`` at B 2 x S 512."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TrainPipeline
    from repro_torch.distributed.mesh import LocalMesh
    from repro_torch.models import model as MDL
    cfg = replace(get_config("llama3.2-1b"), dtype="float32")
    mesh = LocalMesh((2, 4), ("data", "model"))
    for label, B, layout in (("(a)", 8, "fsdp"), ("(b)", 2, "sp")):
        pipe = TrainPipeline(cfg.vocab_size, 512, B)
        t = time.perf_counter()
        mesh_train(label, cfg, lambda: MDL.init_params(
            cfg, seed=0, dtype=torch.float32, device=DEV),
            [pipe.batch(i) for i in range(3)], mesh, smi, fns,
            ref_rt=MDL.Runtime(remat=True), want_layout=layout)
        print(f"[train-sharded] {label} in {time.perf_counter() - t:.1f} s",
              flush=True)


def train_sharded_moe(smi: str, fns) -> None:
    """(c) phi3.5-moe-42b-a6.6b at full width, its first layer of 32, fp32,
    on ``moe_ep``: its 16 experts one a shard on (data 1, model 16),
    ``fsdp`` at B 16 x S 256 (a row a shard), capacity factor 8 (an
    expert's capacity is every token of its shard: no choice dropped). One layer: its experts are 5.0 GB of fp32 weights,
    and the step holds the weights, AdamW's two moments and the new three
    (6 x 6.2 GB) beside the gathered copies; a second layer would not
    fit. The reference is the single-device step whose MoE returns the
    shards' mean of their balance terms (a row each, its own capacity),
    as ``moe_ep``'s mean does."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TrainPipeline
    from repro_torch.distributed.mesh import LocalMesh
    from repro_torch.models import model as MDL
    from repro_torch.models import moe as MOE
    cfg = replace(get_config("phi3.5-moe-42b-a6.6b"), dtype="float32",
                  n_layers=1, capacity_factor=8.0)
    batches = [TrainPipeline(cfg.vocab_size, 256, 16).batch(i)
               for i in range(3)]

    def shard_mean_moe(p, cfg_, x):     # a row a shard, as moe_ep runs it
        ys, auxs = zip(*(MOE.moe_local(p, cfg, x[r:r + 1], with_aux=True)
                         for r in range(x.shape[0])))
        return torch.cat(ys), torch.stack(auxs).mean()

    def aux_mean(params):
        from repro_torch.training.train import to_device
        with torch.no_grad():
            return float(MDL.forward_hidden(
                cfg, params, to_device(batches[0], DEV)["tokens"],
                rt=MDL.Runtime(moe=shard_mean_moe))[1])
    t = time.perf_counter()
    mesh_train("(c)", cfg, lambda: MDL.init_params(
        cfg, seed=0, dtype=torch.float32, device=DEV, moe_virtual=16),
        batches, LocalMesh((1, 16), ("data", "model")), smi, fns,
        ref_rt=MDL.Runtime(remat=True, moe=shard_mean_moe),
        want_layout="fsdp", aux_ref=aux_mean)
    print(f"[train-sharded] (c) in {time.perf_counter() - t:.1f} s",
          flush=True)


def dryrun_cells(smi: str) -> None:
    """One dry-run cell per shape kind on this machine's CPU (meta
    tensors, no card): llama3.2-1b train_4k and prefill_32k on pod1,
    decode_32k on pod2 as the pipeline; their roofline terms at the
    card's datasheet figures."""
    from repro_torch.launch import dryrun as DR
    for arch, shape, mp, mode in (("llama3.2-1b", "train_4k", False, "dp"),
                                  ("llama3.2-1b", "prefill_32k", False,
                                   "dp"),
                                  ("llama3.2-1b", "decode_32k", True,
                                   "pp")):
        r = DR.run_cell(arch, shape, multi_pod=mp, pod_mode=mode,
                        save=False, verbose=False)
        if not r["ok"]:
            fail(f"dry-run {r['cell']}: {r['error']}")
        h, t, m = r["hlo"], r["roofline"], r["memory"]
        print(f"[train-sharded] dry-run {r['cell']} ({r['layout']}, "
              f"{r['devices']} shards, built in {r['t_build_s']} s): flops "
              f"{h['flops']:.4e}, unfused bytes {h['hbm_bytes']:.4e}, "
              f"collective bytes {h['collective_bytes']:.4e}, peak "
              f"{m['peak_bytes'] / 2**30:.2f} GiB a shard; at 989 TF/s, "
              f"3.35 TB/s, 450 GB/s (datasheet): compute "
              f"{t['t_compute'] * 1e3:.3f} ms, memory "
              f"{t['t_memory'] * 1e3:.3f} ms, collective "
              f"{t['t_collective'] * 1e3:.3f} ms: {t['bottleneck']}",
              flush=True)


def phase_train_sharded(smi: str, launches: dict) -> None:
    """Phase 16: the sharded train step, (a)-(c), and the dry-run."""
    fns = _kernel_fns()
    t0 = time.perf_counter()
    _free()
    print(f"[train-sharded] device memory held by earlier phases: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    train_sharded_dense(smi, fns)
    train_sharded_moe(smi, fns)
    t = time.perf_counter()
    dryrun_cells(smi)
    print(f"[train-sharded] dry-run cells in {time.perf_counter() - t:.1f} "
          "s", flush=True)
    print(f"[train-sharded] phase 16 in {time.perf_counter() - t0:.1f} s",
          flush=True)


# ---------------------------------------------------------------------------
# 17. a ProcessMesh on the card: two ranks holding their state resident
# ---------------------------------------------------------------------------

MESH_SHAPE = ((1, 2), ("data", "model"))
MESH_STEPS = 8                  # (a): resident decode steps after prefill
MESH_TRAIN_STEPS = 3            # (b): resident train steps
MESH_PP_SHAPE = ((2, 1, 1), ("pod", "data", "model"))   # (c): 2 stages
MESH_PP_MBS = 2                 # (c): microbatches a decode step


def _tree_bytes(tree) -> int:
    from repro_torch.training.optimizer import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _held(make, cut, label: str, want: int, whole: int, out: dict):
    """``cut(make())``: the rank's resident part of a global tree made on
    the card, the global tree freed; records the device memory it holds
    (``torch.cuda.memory_allocated`` before and after) beside the plan's
    count of its slices, and fails unless they agree within 1% (a whole
    copy would be twice the slices' bytes or more)."""
    _free()
    m0 = torch.cuda.memory_allocated()
    glob = make()
    part = cut(glob)
    del glob
    _free()
    held = torch.cuda.memory_allocated() - m0
    out[label] = {"held": held, "plan": want, "whole": whole}
    if abs(held - want) > 0.01 * want:
        fail(f"phase 17 {label}: the rank holds {held} bytes, its slices "
             f"under the plan are {want}")
    return part


def _mesh_serve(mesh, rank: int, fns, res: dict) -> dict:
    """(a) on this rank: the sharded prefill, then ``MESH_STEPS`` decode
    steps, on resident params and state; returns what rank 0 compares."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import (make_decode_step,
                                                  make_prefill_step)
    from repro_torch.models import model as MDL
    cfg = replace(get_config("llama3.2-1b"), dtype="float32")
    case = _mesh_serve_case(cfg, mesh, MESH_STEPS)
    B, steps = 8, MESH_STEPS
    parallel, spec = case["parallel"], case["spec"]
    pre_plan, plan = case["pre_plan"], case["plan"]
    meta = MDL.init_params(cfg, device="meta")
    meta_state = MDL.init_decode_state(cfg, spec, B, device="meta")
    p_serve_spec = plan.param_specs(meta, mode="serve")
    p_train_spec = pre_plan.param_specs(meta, mode="train")
    s_spec = plan.state_specs(meta_state)
    mem = res.setdefault("memory", {})
    params = lambda: MDL.init_params(cfg, seed=0, dtype=torch.float32,
                                     device=DEV)
    p_serve = _held(params, lambda t: plan.shard(t, p_serve_spec),
                    "serve slices", plan.local_bytes(meta, p_serve_spec),
                    _tree_bytes(meta), mem)
    p_train = _held(params, lambda t: pre_plan.shard(t, p_train_spec),
                    "prefill FSDP slices",
                    pre_plan.local_bytes(meta, p_train_spec),
                    _tree_bytes(meta), mem)
    st = _held(lambda: MDL.init_decode_state(cfg, spec, B, device=DEV),
               lambda t: plan.shard(t, s_spec), "pool block",
               plan.local_bytes(meta_state, s_spec),
               _tree_bytes(meta_state), mem)
    ptr = st["pool"]["k"].data_ptr()
    pre_step = make_prefill_step(cfg, pre_plan, parallel, spec,
                                 specs=p_train_spec)
    step = make_decode_step(cfg, plan, parallel, spec, specs=p_serve_spec)
    batch, step_args = case["batch"], case["step_args"]
    reset_counts(fns)
    torch.cuda.synchronize()
    t = time.perf_counter()
    lg0, st = pre_step(p_train, st, batch)
    torch.cuda.synchronize()
    pre_ms = 1e3 * (time.perf_counter() - t)
    del p_train
    _free()
    la_pre = launch_counts(fns)
    V = cfg.vocab_size
    tok = lg0[:, :V].argmax(-1).to(torch.int32)
    toks, lgs, ms = [tok], [], []
    reset_counts(fns)
    for j in range(steps):
        ctx, npage, noff = step_args(j)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, st = step(p_serve, st, {"tokens": tok, "bt": batch["bt"],
                                    "ctx": ctx, "npage": npage,
                                    "noff": noff})
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        lgs.append(lg)
        tok = lg[:, :V].argmax(-1).to(torch.int32)
        toks.append(tok)
    la_dec = launch_counts(fns)
    if st["pool"]["k"].data_ptr() != ptr:
        fail("phase 17 (a): the pool block was copied inside a step")
    res["serve"] = {"prefill_ms": pre_ms, "decode_ms": ms,
                    "launches_prefill": la_pre, "launches_decode": la_dec,
                    "staged_bytes": mesh.staged_bytes}
    # K1 on this rank's own block (its pages, its own trash page after
    # them), the local table (its pages by local id, -1 elsewhere), layer 0
    # at the last step's context: against its plain version
    P_loc = st["pool"]["k"].shape[1] - 1
    my = mesh.index(rank, plan.page_axes)
    bt = batch["bt"].long()
    bt_loc = torch.where((bt >= my * P_loc) & (bt < (my + 1) * P_loc),
                         bt - my * P_loc, -1).to(torch.int32)
    g = torch.Generator(device=DEV)
    g.manual_seed(17 + rank)
    q = torch.randn((B, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                     cfg.d_head), generator=g, device=DEV)
    kp, vp = (st["pool"][n][0].narrow(0, 0, P_loc) for n in ("k", "v"))
    k1 = check_paged(None, torch.float32, n_splits=SHARD_SPLITS,
                     time_it=True, inputs=(q, kp, vp, bt_loc,
                                           step_args(steps - 1)[0]))
    if not k1["ok"]:
        fail(f"phase 17 (a): K1 on rank {rank}'s block misses its plain "
             f"version by {k1['max_abs_err']:.3e}")
    res["serve"]["k1_local"] = {k: k1[k] for k in (
        "max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by")}
    res["serve"]["k1_local"]["block"] = list(kp.shape)
    full = plan.gather(st, s_spec)      # on every rank (an all-gather)
    out = {"toks": [t.cpu() for t in toks], "lg0": lg0.cpu(),
           "lgs": [x.cpu() for x in lgs],
           "pool": {n: full["pool"][n][:, :spec.n_pages].cpu()
                    for n in ("k", "v")}}
    del full, st, p_serve, lgs, lg0
    _free()
    return out


def _mesh_serve_case(cfg, mesh, steps: int) -> dict:
    """Phase 15 (b)'s and 17 (a)'s geometry on ``mesh``: 8 rows of 256-1024
    tokens (padded to 1024; seed 15) in pages of 16, room for ``steps``
    decode steps, ``row_affine`` over the mesh's data rows (4 rows a data
    row on (2, 4)) with ``blocked_chunk`` a model shard's block of the
    sequence; its plans, batch and step arguments."""
    from repro_torch.configs import ParallelConfig, ShapeConfig
    from repro_torch.core.allocator import PageAllocator
    from repro_torch.core.paged_kv import PoolSpec
    from repro_torch.distributed.sharding import make_plan
    B, S, page = 8, 1024, 16
    n_shards, tp, dp = mesh.size, mesh.shape["model"], mesh.shape["data"]
    rng = np.random.default_rng(15)
    lens = rng.integers(256, S + 1, B)
    maxp = (S + steps) // page + 1
    n_pages = 768
    parallel = ParallelConfig(page_size=page, kernel_splits=SHARD_SPLITS,
                              remat=False)
    alloc = PageAllocator(n_pages, n_shards, page, policy="row_affine",
                          n_rows=dp, blocked_chunk=S // tp // page)
    for b in range(B):
        alloc.admit(b, int(lens[b]) + steps, row=b // (B // dp))
    bt = torch.tensor(np.stack([alloc.block_table(b, maxp)
                                for b in range(B)]), dtype=torch.int32,
                      device=DEV)
    spec = PoolSpec(cfg.n_layers, n_pages, page, cfg.n_kv_heads, cfg.d_head,
                    maxp, dtype="float32")
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                          device=DEV)
    valid = torch.tensor(lens, device=DEV)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=DEV)
    rows = torch.arange(B, device=DEV)

    def step_args(j):
        pos = lens_t + j
        return (pos + 1, bt[rows, (pos // page).long()].contiguous(),
                (pos % page).to(torch.int32))
    return {"parallel": parallel, "spec": spec, "step_args": step_args,
            "lens": lens,
            "pre_plan": make_plan(mesh, parallel,
                                  ShapeConfig("p", "prefill", S, B),
                                  train_layout="sp"),
            "plan": make_plan(mesh, parallel,
                              ShapeConfig("d", "decode", S + steps, B)),
            "batch": {"tokens": tokens, "bt": bt, "valid_len": valid,
                      "last_idx": valid - 1}}


def _mesh_train(mesh, rank: int, fns, res: dict) -> dict:
    """(b) on this rank: ``MESH_TRAIN_STEPS`` ``fsdp`` train steps of
    llama3.2-1b at B 8 x S 512 on resident params and moments; returns
    the losses, grad norms and the gathered params and first moments."""
    from repro_torch.configs import ParallelConfig, ShapeConfig, get_config
    from repro_torch.data.pipeline import TrainPipeline
    from repro_torch.distributed.sharding import make_plan
    from repro_torch.models import model as MDL
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train import make_train_step, to_device
    cfg = replace(get_config("llama3.2-1b"), dtype="float32")
    B, S = 8, 512
    plan = make_plan(mesh, ParallelConfig(), ShapeConfig("t", "train", S, B))
    if plan.train_layout != "fsdp":
        fail(f"phase 17 (b): the plan chose {plan.train_layout}")
    meta = MDL.init_params(cfg, device="meta")
    spec = plan.param_specs(meta, mode="train")
    o_spec = {"m": spec, "v": spec, "step": None}
    mem = res.setdefault("memory", {})

    def resident(glob):
        p = plan.shard(glob, spec)
        return p, OPT.init(p)
    p, opt = _held(lambda: MDL.init_params(cfg, seed=0, dtype=torch.float32,
                                           device=DEV), resident,
                   "params + moments", 3 * plan.local_bytes(meta, spec) + 4,
                   3 * _tree_bytes(meta) + 4, mem)
    ocfg = OPT.AdamWConfig(**TRAIN_OPT)
    step = make_train_step(cfg, plan.make_runtime(cfg, ParallelConfig(),
                                                  mode="train"), ocfg,
                           specs=spec)
    batches = [to_device(TrainPipeline(cfg.vocab_size, S, B).batch(i), DEV)
               for i in range(MESH_TRAIN_STEPS)]
    losses, gnorms, ms = [], [], []
    staged = mesh.staged_bytes
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fns)
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        p, opt, m = step(p, opt, b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    res["train"] = {"ms": ms, "losses": losses, "gnorms": gnorms,
                    "launches": launch_counts(fns),
                    "peak": torch.cuda.max_memory_allocated(),
                    "staged_bytes": mesh.staged_bytes - staged}
    out = {"losses": losses, "gnorms": gnorms,
           "params": [x.cpu() for x in OPT.tree_leaves(
               plan.gather(p, spec))]}
    del p
    _free()
    out["m"] = [x.cpu() for x in OPT.tree_leaves(
        plan.gather(opt, o_spec)["m"])]
    del opt
    _free()
    return out


def _mesh_pp_case(cfg, mesh) -> dict:
    """Phase 15 (d)'s pipeline geometry for (c) on ``mesh``: 4 rows of 256
    prompt tokens (seed 16) in pages of 16 on one page shard, room for
    ``MESH_STEPS`` decode steps; its plan, pool spec, table and tokens."""
    from repro_torch.configs import ParallelConfig, ShapeConfig
    from repro_torch.core.allocator import PageAllocator
    from repro_torch.core.paged_kv import PoolSpec
    from repro_torch.distributed.sharding import make_plan
    B, S_pre, page, n_pages = 4, 256, 16, 96
    S = S_pre + MESH_STEPS
    maxp = S // page + 1
    parallel = ParallelConfig(page_size=page, remat=False)
    alloc = PageAllocator(n_pages, 1, page)
    for b in range(B):
        alloc.admit(b, S)
    bt = torch.tensor(np.stack([alloc.block_table(b, maxp)
                                for b in range(B)]), dtype=torch.int32,
                      device=DEV)
    rng = np.random.default_rng(16)
    return {"parallel": parallel, "S_pre": S_pre, "page": page, "bt": bt,
            "spec": PoolSpec(cfg.n_layers, n_pages, page, cfg.n_kv_heads,
                             cfg.d_head, maxp, dtype="float32"),
            "toks": torch.tensor(rng.integers(0, cfg.vocab_size,
                                              (B, S_pre)), device=DEV),
            "plan": make_plan(mesh, parallel, ShapeConfig("d", "decode", S,
                                                          B),
                              pod_mode="pp")}


def _pp_batch(case, tok, j: int) -> dict:
    """(c)'s decode step ``j``: ``tok`` at position ``S_pre + j``."""
    t, page, bt = case["S_pre"] + j, case["page"], case["bt"]
    B = bt.shape[0]
    return {"tokens": tok, "bt": bt,
            "ctx": torch.full((B,), t + 1, dtype=torch.int32, device=DEV),
            "npage": bt[:, t // page].contiguous(),
            "noff": torch.full((B,), t % page, dtype=torch.int32,
                               device=DEV)}


def _pp_prefill(cfg, params, case):
    """(c)'s prompts through the unsharded prefill (K2) into a fresh
    global pool: (the last position's logits, the state)."""
    from repro_torch.kernels.backend import KernelConfig
    from repro_torch.models import model as MDL
    state = MDL.init_decode_state(cfg, case["spec"], case["bt"].shape[0],
                                  device=DEV)
    return MDL.prefill(cfg, params, state, case["toks"], case["bt"],
                       rt=MDL.Runtime(kernels=KernelConfig()))


def _mesh_pipeline(mesh, rank: int, fns, res: dict) -> dict:
    """(c) on this rank: the pipeline (``make_pp_decode_step``, 2 stages,
    ``MESH_PP_MBS`` microbatches) on ``MESH_PP_SHAPE``, the rank holding
    only its stage's layers (``stage_specs``) and its stage's pool block,
    filled by the unsharded prefill and cut with ``Plan.shard`` (the
    global trees freed before anything is measured); then
    ``MESH_STEPS`` greedy decode steps. Returns what rank 0 compares."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.pipeline import (make_pp_decode_step,
                                                  stage_specs)
    from repro_torch.models import model as MDL
    cfg = replace(get_config("llama3.2-1b"), dtype="float32")
    case = _mesh_pp_case(cfg, mesh)
    plan, spec, B = case["plan"], case["spec"], case["bt"].shape[0]
    meta = MDL.init_params(cfg, device="meta")
    meta_state = MDL.init_decode_state(cfg, spec, B, device="meta")
    p_spec = stage_specs(plan, plan.param_specs(meta, mode="serve"))
    s_spec = plan.state_specs(meta_state)
    mem = res.setdefault("memory", {})
    params = lambda: MDL.init_params(cfg, seed=0, dtype=torch.float32,
                                     device=DEV)
    lg0: dict = {}

    def prefilled():
        lg, state = _pp_prefill(cfg, params(), case)
        lg0["lg"] = lg.cpu()
        return state
    reset_counts(fns)
    st = _held(prefilled, lambda t: plan.shard(t, s_spec),
               "(c) stage pool block", plan.local_bytes(meta_state, s_spec),
               _tree_bytes(meta_state), mem)
    la_pre = launch_counts(fns)
    p = _held(params, lambda t: plan.shard(t, p_spec), "(c) stage params",
              plan.local_bytes(meta, p_spec), _tree_bytes(meta), mem)
    step = make_pp_decode_step(cfg, plan, case["parallel"], spec,
                               n_stages=2, microbatches=MESH_PP_MBS,
                               specs=p_spec)
    ptr = st["pool"]["k"].data_ptr()
    V = cfg.vocab_size
    tok = lg0["lg"][:, :V].argmax(-1).to(torch.int32).to(DEV)
    toks, lgs, ms = [tok], [], []
    staged = mesh.staged_bytes
    reset_counts(fns)
    for j in range(MESH_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, st = step(p, st, _pp_batch(case, tok, j))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        lgs.append(lg)
        tok = lg[:, :V].argmax(-1).to(torch.int32)
        toks.append(tok)
    la_dec = launch_counts(fns)
    if st["pool"]["k"].data_ptr() != ptr:
        fail("phase 17 (c): the pool block was copied inside a step")
    res["pipeline"] = {"decode_ms": ms, "launches_prefill": la_pre,
                       "launches_decode": la_dec,
                       "staged_bytes": mesh.staged_bytes - staged,
                       "layers": len(p["layers"]),
                       "n_layers": cfg.n_layers}
    # K1 on the rank's stage block (its stage's first layer, every page and
    # the trash page), the first microbatch at the last step's context
    mb = B // MESH_PP_MBS
    g = torch.Generator(device=DEV)
    g.manual_seed(27 + rank)
    q = torch.randn((mb, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                     cfg.d_head), generator=g, device=DEV)
    kp, vp = (st["pool"][n][0] for n in ("k", "v"))
    k1 = check_paged(None, torch.float32,
                     n_splits=case["parallel"].kernel_splits, time_it=True,
                     inputs=(q, kp, vp, case["bt"][:mb],
                             _pp_batch(case, tok, MESH_STEPS - 1)["ctx"][
                                 :mb]))
    if not k1["ok"]:
        fail(f"phase 17 (c): K1 on rank {rank}'s stage block misses its "
             f"plain version by {k1['max_abs_err']:.3e}")
    res["pipeline"]["k1_stage"] = {k: k1[k] for k in (
        "max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by")}
    res["pipeline"]["k1_stage"]["block"] = list(kp.shape)
    full = plan.gather(st, s_spec)      # on every rank (an all-gather)
    out = {"toks": [t.cpu() for t in toks], "lg0": lg0["lg"],
           "lgs": [x.cpu() for x in lgs],
           "pool": {n: full["pool"][n][:, :spec.n_pages].cpu()
                    for n in ("k", "v")}}
    del full, st, p, lgs
    _free()
    return out


def mesh_rank(rank: int, port: int, out: Path) -> int:
    """One rank of phase 17 (``chip_smoke.py --mesh-rank R PORT DIR``, run
    by ``phase_process_mesh``): a gloo world of ``MESH_SHAPE``'s ranks on
    the one card (NCCL refuses two ranks on one device; gloo's collectives
    run on host tensors, so ``ProcessMesh`` stages the CUDA tensors
    through host memory); (a) and (b) on resident state, the results
    gathered; rank 0 then runs the same steps on a ``LocalMesh`` and
    holds the gathered results to them. Writes ``DIR/rank<R>.json``."""
    import torch.distributed as dist
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.distributed.mesh import ProcessMesh
    torch.cuda.set_device(0)
    # the embedding's backward (an accumulating index) repeatable, so the
    # two meshes' steps can agree bit for bit
    torch.use_deterministic_algorithms(True, warn_only=True)
    n = int(np.prod(MESH_SHAPE[0]))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        mesh = ProcessMesh(*MESH_SHAPE)
        fns = _kernel_fns()
        res: dict = {"rank": rank, "staged": mesh.staged}
        t0 = time.perf_counter()
        serve = _mesh_serve(mesh, rank, fns, res)
        train = _mesh_train(mesh, rank, fns, res)
        dist.barrier()
        # (c) a second mesh over the same two processes
        t1 = time.perf_counter()
        pipeline = _mesh_pipeline(ProcessMesh(*MESH_PP_SHAPE), rank, fns,
                                  res)
        res["pipeline_s"] = time.perf_counter() - t1
        res["process_mesh_s"] = time.perf_counter() - t0
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        t0 = time.perf_counter()
        res["local"] = _mesh_against_local(serve, train, fns)
        t1 = time.perf_counter()
        res["local_pp"] = _mesh_pp_against_local(pipeline, fns)
        res["local_pp_s"] = time.perf_counter() - t1
        res["local_s"] = time.perf_counter() - t0
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    return 0


def _mesh_against_local(serve: dict, train: dict, fns) -> dict:
    """Rank 0: (a) and (b) on a ``LocalMesh`` of ``MESH_SHAPE`` in this
    process (its shards threads, resident tensors the global ones), fed
    the ProcessMesh's tokens: greedy tokens identical (C.3's near-tie
    rule), logits and the pool's pages within 1e-5 of their scale, each
    train step's loss and grad norm within 1e-5 relative, the params and
    first moments within 1e-4 of each leaf's scale (phase 16's bounds).
    Returns the gaps."""
    from repro_torch.configs import ParallelConfig, ShapeConfig, get_config
    from repro_torch.data.pipeline import TrainPipeline
    from repro_torch.distributed.mesh import LocalMesh
    from repro_torch.distributed.sharding import (make_decode_step, make_plan,
                                                  make_prefill_step)
    from repro_torch.models import model as MDL
    from repro_torch.training import optimizer as OPT
    from repro_torch.training.train import make_train_step, to_device
    cfg = replace(get_config("llama3.2-1b"), dtype="float32")
    mesh = LocalMesh(*MESH_SHAPE)
    case = _mesh_serve_case(cfg, mesh, MESH_STEPS)
    params = MDL.init_params(cfg, seed=0, dtype=torch.float32, device=DEV)
    state = MDL.init_decode_state(cfg, case["spec"], 8, device=DEV)
    pre = make_prefill_step(cfg, case["pre_plan"], case["parallel"],
                            case["spec"], specs=case["pre_plan"].param_specs(
                                params, mode="train"))
    step = make_decode_step(cfg, case["plan"], case["parallel"],
                            case["spec"], specs=case["plan"].param_specs(
                                params, mode="serve"))
    reset_counts(fns)
    lg0, state = pre(params, state, case["batch"])
    gaps = {"logits": _logit_gap(serve["lg0"].to(DEV), lg0)}
    gaps["max_logit_gap"] = _greedy_check("phase 17 (a) prefill", cfg,
                                          serve["lg0"].to(DEV), lg0,
                                          serve["toks"][0].to(DEV))
    batch = case["batch"]
    for j in range(MESH_STEPS):
        ctx, npage, noff = case["step_args"](j)
        lg, state = step(params, state, {
            "tokens": serve["toks"][j].to(DEV), "bt": batch["bt"],
            "ctx": ctx, "npage": npage, "noff": noff})
        got = serve["lgs"][j].to(DEV)
        gaps["max_logit_gap"] = max(gaps["max_logit_gap"], _greedy_check(
            "phase 17 (a)", cfg, got, lg, serve["toks"][j + 1].to(DEV)))
        gaps["logits"] = max(gaps["logits"], _logit_gap(got, lg))
    n = case["spec"].n_pages
    gaps["pages"] = max(_logit_gap(serve["pool"][k].to(DEV),
                                   state["pool"][k][:, :n]) for k in "kv")
    gaps["bit_equal_serve"] = bool(
        gaps["logits"] == 0 and gaps["pages"] == 0)
    gaps["launches_serve"] = launch_counts(fns)
    del params, state, lg0, lg
    _free()
    B, S = 8, 512
    plan = make_plan(mesh, ParallelConfig(), ShapeConfig("t", "train", S, B))
    p = MDL.init_params(cfg, seed=0, dtype=torch.float32, device=DEV)
    step = make_train_step(cfg, plan.make_runtime(cfg, ParallelConfig(),
                                                  mode="train"),
                           OPT.AdamWConfig(**TRAIN_OPT),
                           specs=plan.param_specs(p, mode="train"))
    opt = OPT.init(p)
    losses, gnorms = [], []
    for i in range(MESH_TRAIN_STEPS):
        p, opt, m = step(p, opt, to_device(
            TrainPipeline(cfg.vocab_size, S, B).batch(i), DEV))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    gaps["loss"] = max(abs(a - b) / abs(b) for a, b in zip(train["losses"],
                                                           losses))
    gaps["grad_norm"] = max(abs(a - b) / abs(b)
                            for a, b in zip(train["gnorms"], gnorms))
    gaps["params"] = _moment_gap(train["params"], [
        x.detach().cpu() for x in OPT.tree_leaves(p)])
    gaps["first_moments"] = _moment_gap(train["m"], _first_moments(opt))
    gaps["bit_equal_train"] = bool(
        gaps["loss"] == 0 and gaps["params"] == 0
        and gaps["first_moments"] == 0)
    del p, opt
    _free()
    bad = [k for k, bound in (("logits", 1e-5), ("pages", 1e-5),
                              ("loss", 1e-5), ("grad_norm", 1e-5),
                              ("params", 1e-4), ("first_moments", 1e-4))
           if not gaps[k] <= bound]
    if bad:
        fail(f"phase 17: the ProcessMesh's gathered results differ from the "
             f"LocalMesh's in {bad}: {gaps}")
    return gaps


def _mesh_pp_against_local(pp: dict, fns) -> dict:
    """Rank 0: (c) on a ``LocalMesh`` of ``MESH_PP_SHAPE`` in this process
    (the resident params the global ones, each shard handed its stage's
    layers), fed the ProcessMesh's tokens: the prefill's logits, the
    steps' logits and the pool's pages bit-equal; then the unsharded step
    (K1) on a copy of the same prefilled pool, fed the same tokens: greedy
    tokens identical (C.3), logits within 1e-5 of their scale. Returns
    the gaps."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.mesh import LocalMesh
    from repro_torch.distributed.pipeline import (make_pp_decode_step,
                                                  stage_specs)
    from repro_torch.kernels.backend import KernelConfig
    from repro_torch.models import model as MDL
    cfg = replace(get_config("llama3.2-1b"), dtype="float32")
    case = _mesh_pp_case(cfg, LocalMesh(*MESH_PP_SHAPE))
    plan, spec = case["plan"], case["spec"]
    params = MDL.init_params(cfg, seed=0, dtype=torch.float32, device=DEV)
    reset_counts(fns)
    lg0, state = _pp_prefill(cfg, params, case)
    state_u = {"pool": {k: v.clone() for k, v in state["pool"].items()}}
    step = make_pp_decode_step(cfg, plan, case["parallel"], spec,
                               n_stages=2, microbatches=MESH_PP_MBS,
                               specs=stage_specs(plan, plan.param_specs(
                                   params, mode="serve")))
    toks = [t.to(DEV) for t in pp["toks"]]
    gaps = {"prefill": float((pp["lg0"].to(DEV) - lg0).abs().max()),
            "logits": 0.0}
    for j in range(MESH_STEPS):
        lg, state = step(params, state, _pp_batch(case, toks[j], j))
        gaps["logits"] = max(gaps["logits"], float(
            (pp["lgs"][j].to(DEV) - lg).abs().max()))
    gaps["launches"] = launch_counts(fns)
    n = spec.n_pages
    gaps["pages"] = max(float((pp["pool"][k].to(DEV)
                               - state["pool"][k][:, :n]).abs().max())
                        for k in ("k", "v"))
    gaps["bit_equal"] = gaps["prefill"] == gaps["logits"] == \
        gaps["pages"] == 0
    del state
    rt_u, err, tgap = MDL.Runtime(kernels=KernelConfig()), 0.0, 0.0
    for j in range(MESH_STEPS):
        b = _pp_batch(case, toks[j], j)
        lg, _ = MDL.decode_step(cfg, params, state_u, b["tokens"], b["bt"],
                                b["ctx"], b["npage"], b["noff"], rt=rt_u)
        got = pp["lgs"][j].to(DEV)
        err = max(err, _logit_gap(got, lg))
        tgap = max(tgap, _greedy_check("phase 17 (c)", cfg, got, lg,
                                       toks[j + 1]))
    gaps["unsharded"], gaps["max_logit_gap"] = err, tgap
    del params, state_u
    _free()
    if not gaps["bit_equal"]:
        fail(f"phase 17 (c): the ProcessMesh pipeline's gathered results "
             f"differ from the LocalMesh's: {gaps}")
    if not err <= 1e-5:
        fail(f"phase 17 (c): pipeline logits differ from the unsharded "
             f"step by {err:.3e} of scale (bound 1e-5)")
    return gaps


def phase_process_mesh(smi: str, launches: dict) -> None:
    """Phase 17: a ``ProcessMesh`` on the card for the first time: two
    ranks (``MESH_SHAPE``, both on the one H100, over gloo with their CUDA
    tensors staged through host memory), each holding only its own part
    of the state (``Plan.shard``): (a) llama3.2-1b at full width, fp32,
    random weights from seed 0, the sharded prefill of phase 15 (b)'s 8
    rows, then ``MESH_STEPS`` resident decode steps (TP over ``model``,
    ITPP over the rank's own page block); (b) ``MESH_TRAIN_STEPS``
    resident ``fsdp`` train steps at phase 16 (a)'s B 8 x S 512. Each rank
    prints the device memory its resident params, moments and pool block
    take beside the plan's count of its slices and the whole model, its
    step ms, and K1 on its own page block against its plain version; the
    results gathered at the end are held to the same steps on a
    ``LocalMesh``. Launches: K2 16 a rank (the prefill), K1 16 x
    ``MESH_STEPS`` a rank, none in training. (c) the pipeline on
    ``MESH_PP_SHAPE`` over the same processes, a rank holding its stage's
    layers only: K2 16 (the unsharded prefill) and K1 8 x
    ``MESH_PP_MBS`` x ``MESH_STEPS`` a rank, gathered results bit-equal
    to a ``LocalMesh``'s, tokens to the unsharded step's."""
    import os
    import socket
    import shutil
    out = HERE / "build" / "process_mesh"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(HERE / "src"),
           "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    n = int(np.prod(MESH_SHAPE[0]))
    t0 = time.perf_counter()
    logs = [open(out / f"rank{r}.log", "w") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "chip_smoke.py"), "--mesh-rank", str(r),
         str(port), str(out)], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(n)]
    try:
        deadline = time.perf_counter() + 600
        while any(pr.poll() is None for pr in procs):
            if time.perf_counter() > deadline or any(
                    pr.returncode not in (None, 0) for pr in procs):
                break
            time.sleep(0.5)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
            pr.wait()
        for f in logs:
            f.close()
    for r in range(n):
        text = (out / f"rank{r}.log").read_text()
        tail = "\n".join(text.splitlines()[-40:])
        if procs[r].returncode or not (out / f"rank{r}.json").exists():
            fail(f"phase 17: rank {r} exited with {procs[r].returncode}:\n"
                 f"{tail}")
    wall = time.perf_counter() - t0
    res = [json.loads((out / f"rank{r}.json").read_text()) for r in range(n)]
    from repro_torch.configs import get_config
    cfg_layers = get_config("llama3.2-1b").n_layers
    for r in res:
        tag = f"[mesh] rank {r['rank']}/{n}"
        for label, m in r["memory"].items():
            print(f"{tag}: {label} {m['held'] / 1e9:.3f} GB on the card "
                  f"(torch.cuda.memory_allocated: {m['held']} B), the "
                  f"plan's count of its slices {m['plan'] / 1e9:.3f} GB "
                  f"({m['plan']} B), whole {m['whole'] / 1e9:.3f} GB | "
                  f"{smi}", flush=True)
        sv, tr, k1 = r["serve"], r["train"], r["serve"]["k1_local"]
        print(f"{tag}: (a) llama3.2-1b {cfg_layers} layers, 8 rows, prefill "
              f"ms {sv['prefill_ms']:.1f} (make_prefill_step, sp, FSDP "
              f"slices), decode step ms "
              + " ".join(f"{x:.2f}" for x in sv["decode_ms"])
              + f" (make_decode_step, TP over model, ITPP on the rank's "
              f"block); collectives staged through host memory "
              f"{sv['staged_bytes'] / 1e9:.3f} GB (gloo) | {smi}", flush=True)
        print(f"{tag}: K1 on its own block {k1['block']} (its pages, then "
              f"its own trash page), local table: max_abs_err "
              f"{k1['max_abs_err']:.3e} (tolerance {TOL[torch.float32]}) ms "
              f"{k1['ms']:.4f} (graph replay {k1['graph_ms']:.4f}) bound_ms "
              f"{k1['bound_ms']:.4f} ({k1['bound_by']}) plain_ms "
              f"{k1['plain_ms']:.4f} | {smi}", flush=True)
        print(f"{tag}: (b) fsdp B 8 x S 512, step ms "
              + " ".join(f"{x:.1f}" for x in tr["ms"]) + ", losses "
              + " ".join(f"{x:.6f}" for x in tr["losses"])
              + f", peak device GB {tr['peak'] / 1e9:.2f}, collectives "
              f"staged through host memory {tr['staged_bytes'] / 1e9:.3f} "
              f"GB | {smi}", flush=True)
        la = {k: sv["launches_prefill"][k] + sv["launches_decode"][k]
              + tr["launches"][k] for k in sv["launches_decode"]}
        want = {"flash_attention": cfg_layers,
                "paged_attention": cfg_layers * MESH_STEPS}
        _check_path(f"phase 17 rank {r['rank']}", la, want, launches)
        pl, k1 = r["pipeline"], r["pipeline"]["k1_stage"]
        print(f"{tag}: (c) pipeline llama3.2-1b on {MESH_PP_SHAPE[0]} over "
              f"{MESH_PP_SHAPE[1]}: the rank holds {pl['layers']} of "
              f"{pl['n_layers']} layers, {MESH_PP_MBS} microbatches, B 4, "
              f"256 prefilled (unsharded, K2) + {MESH_STEPS} greedy decode "
              f"steps, step ms " + " ".join(f"{x:.2f}"
                                           for x in pl["decode_ms"])
              + f"; collectives staged through host memory "
              f"{pl['staged_bytes'] / 1e6:.3f} MB (gloo) | {smi}",
              flush=True)
        print(f"{tag}: (c) K1 on its stage block {k1['block']} (every "
              f"page, then the trash page): max_abs_err "
              f"{k1['max_abs_err']:.3e} (tolerance {TOL[torch.float32]}) ms "
              f"{k1['ms']:.4f} (graph replay {k1['graph_ms']:.4f}) bound_ms "
              f"{k1['bound_ms']:.4f} ({k1['bound_by']}) plain_ms "
              f"{k1['plain_ms']:.4f} | {smi}", flush=True)
        if 2 * pl["layers"] != pl["n_layers"]:
            fail(f"phase 17 (c): rank {r['rank']} holds {pl['layers']} "
                 f"layers, not its stage's {pl['n_layers'] // 2}")
        la = {k: pl["launches_prefill"][k] + pl["launches_decode"][k]
              for k in pl["launches_decode"]}
        _check_path(f"phase 17 (c) rank {r['rank']}", la, {
            "flash_attention": cfg_layers,
            "paged_attention": cfg_layers // 2 * MESH_PP_MBS * MESH_STEPS},
            launches)
    gp = res[0]["local_pp"]
    lw = {k: v for k, v in gp["launches"].items() if v}
    if lw != {"flash_attention": cfg_layers,
              "paged_attention": cfg_layers * MESH_PP_MBS * MESH_STEPS}:
        fail(f"phase 17 (c): the LocalMesh reference launched {lw}")
    print(f"[mesh] (c) on the ranks "
          + " / ".join(f"{r['pipeline_s']:.1f}" for r in res)
          + f" s; gathered against the LocalMesh {MESH_PP_SHAPE[0]} "
          f"(rank 0, {res[0]['local_pp_s']:.1f} s): prefill logits {gp['prefill']:.3e}, step logits "
          f"{gp['logits']:.3e}, pool pages {gp['pages']:.3e} (bit-equal "
          f"{gp['bit_equal']}); the unsharded step: logits "
          f"{gp['unsharded']:.3e} of scale (bound 1e-5), tokens identical "
          f"(max logit gap {gp['max_logit_gap']:.3e})", flush=True)
    g = res[0]["local"]
    lw = {k: v for k, v in g["launches_serve"].items() if v}
    if lw != {"flash_attention": cfg_layers * n,
              "paged_attention": cfg_layers * n * MESH_STEPS}:
        fail(f"phase 17: the LocalMesh reference launched {lw}")
    print(f"[mesh] gathered against the LocalMesh {MESH_SHAPE[0]} (rank 0, "
          f"{res[0]['local_s']:.1f} s): logits {g['logits']:.3e} and pool "
          f"pages {g['pages']:.3e} of scale (bound 1e-5), tokens identical "
          f"(max logit gap {g['max_logit_gap']:.3e}), bit-equal "
          f"{g['bit_equal_serve']}; train loss {g['loss']:.3e}, grad norm "
          f"{g['grad_norm']:.3e} rel (bound 1e-5), params {g['params']:.3e},"
          f" first moments {g['first_moments']:.3e} of scale (bound 1e-4), "
          f"bit-equal {g['bit_equal_train']}", flush=True)
    print(f"[mesh] phase 17 in {wall:.1f} s (ranks' ProcessMesh part "
          + " / ".join(f"{r['process_mesh_s']:.1f}" for r in res)
          + " s)", flush=True)


def kernel_times(src: str, smi: str, paged_only: bool = False) -> None:
    """``--kernel-times SRC``: K1, K2, K3 and K4 of the ``repro_torch``
    under ``SRC`` (this checkout's ``src`` or another's, e.g. an unpacked
    parent commit) timed as in phase 3, in fp32 and bf16, then stop. Run
    parent, change, change, parent in one call to compare two versions.
    ``paged_only`` (``--paged-times``) keeps the fp32 page-16 K1 lines."""
    sys.path.insert(0, str(Path(src).resolve()))
    import repro_torch
    from repro_torch.kernels import build
    root = Path(repro_torch.__file__).parents[1]
    t0 = time.perf_counter()
    build.build_all()
    print(f"[kernel-times] {root}: built in {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    page16 = (("llama n_splits=4", dict(n_splits=4)),
              ("llama n_splits=1", dict(n_splits=1)),
              ("zamba2 G=1 KVH=32 n_splits=4",
               dict(KVH=32, G=1, W=81, ctx_max=1056, n_splits=4)))
    cases = [("paged_attention", n, check_paged, dict(rng=rng, **kw))
             for n, kw in page16]
    if not paged_only:
        cases += [
            ("paged_attention", "page256 D128 B4 KVH2 G4 W8 (bench)",
             check_paged, dict(rng=rng, B=4, KVH=2, G=4, D=128, page=256,
                               W=8, ctx_max=2048)),
            ("paged_attention", "decode-step ctx=262144 n_splits=64",
             check_paged, dict(rng=rng, B=2, KVH=1, G=4, D=32, page=256,
                               W=1025, ctx_max=0, ctx_fixed=262144,
                               n_splits=64)),
            ("flash_attention", "llama Sq=1024", check_flash, {}),
            ("flash_attention", "zamba2 H=KVH=32 Sq=1024", check_flash,
             dict(KVH=32)),
            ("flash_attention", "chunked q_offset=[0,512] Skv=1536",
             check_flash, dict(offs=(0, 512), Skv=1536)),
            ("flash_decode", "bench B4 KVH2 G4 D128 T4001 S8",
             check_flash_decode, dict(B=4, KVH=2, G=4, D=128, T=4001, S=8,
                                      ctx=[4001, 100, 222, 64])),
            ("flash_decode", "long B8 KVH8 G4 D64 T32768 S16",
             check_flash_decode,
             dict(B=8, KVH=8, G=4, D=64, T=32768, S=16,
                  ctx=[int(x) for x in np.linspace(8192, 32768, 8)]))]
        cases += [("ssm_scan", n, check_ssm, kw) for n, kw in SSM_SHAPES]
    dtypes = ((torch.float32,) if paged_only
              else (torch.float32, torch.bfloat16))
    bad = []
    for kern, name, fn, kw in cases:
        for dtype in dtypes:
            tag = "fp32" if dtype == torch.float32 else "bf16"
            r = fn(dtype=dtype, time_it=True, **kw)
            if paged_only:
                print(f"[paged-times] {root} {name}: ms={r['ms']:.4f} "
                      f"bound_ms={r['bound_ms']:.4f} max_abs_err="
                      f"{r['max_abs_err']:.3e} | {smi}", flush=True)
            else:
                print(f"[kernel-times] {root} {kern} {tag} {name}: "
                      f"ms={r['ms']:.4f} "
                      + (f"(graph replay {r['graph_ms']:.4f}) "
                         if "graph_ms" in r else "")
                      + f"bound_ms={r['bound_ms']:.4f} "
                      f"({r['bound_by']}) plain_ms={r['plain_ms']:.4f} "
                      f"library_ms={r.get('library_ms', 'none')} "
                      f"max_abs_err={r['max_abs_err']:.3e} | {smi}",
                      flush=True)
            if not r["ok"]:
                bad.append(f"{kern} {tag} {name}")
    if bad:
        fail("kernels disagree with their plain versions: " + ", ".join(bad))


# K4's timing variants: ssm_scan.cu's SSM_ABLATE bits and what each drops
K4_ABLATIONS = (("whole kernel", 0), ("no score / W / S v loop", 1),
                ("no exp of W", 2), ("no state update", 4),
                ("bf16 q k^T as one TF32 product", 8))


def k4_ablation(smi: str) -> None:
    """``--k4-ablation``: ``ssm_scan.cu`` built once per SSM_ABLATE
    variant (one nvcc each, all started together) and timed as in phase 3
    at zamba2's prefill shape (B8 S1024 chunk 128), fp32 and bf16, at 64
    and 32 P columns a block. Variants 1, 2 and 4 are wrong by design:
    what each saves against the whole kernel is the time of the part it
    drops. Variant 8 (bf16 only) must stay right."""
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.kernels import build
    out = build.BUILD_DIR.parent / "k4_ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {m: subprocess.Popen(
        [build.nvcc_path(), *build.FLAGS, f"-DSSM_ABLATE={m}", "-o",
         str(out / f"ssm_scan_{m}.so"), str(build.CSRC / "ssm_scan.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for _, m in K4_ABLATIONS}
    for m, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            fail(f"ssm_scan.cu with SSM_ABLATE={m} did not build:\n{text}")
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for name, m in K4_ABLATIONS:
            if m == 8 and dtype == torch.float32:
                continue
            build._LIBS["ssm_scan"] = ctypes.CDLL(str(out /
                                                      f"ssm_scan_{m}.so"))
            for ps in (64, 32):
                r = check_ssm(dtype, p_slice=ps, time_it=True)
                if m in (0, 8) and not r["ok"]:
                    fail(f"ssm_scan {tag} SSM_ABLATE={m} p_slice={ps} "
                         "disagrees with its plain version")
                print(f"[k4-ablation] {tag} SSM_ABLATE={m} ({name}) "
                      f"p_slice={ps}: ms={r['ms']:.4f} (graph replay "
                      f"{r['graph_ms']:.4f}) max_rel_err="
                      f"{r['max_rel_err']:.3e} | {smi}", flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--mesh-rank"]:     # a rank of phase 17
        return mesh_rank(int(sys.argv[2]), int(sys.argv[3]),
                         Path(sys.argv[4]))
    t0 = time.perf_counter()
    smi = phase_device()
    if sys.argv[1:2] in (["--kernel-times"], ["--paged-times"]):
        kernel_times(sys.argv[2], smi, sys.argv[1] == "--paged-times")
        return 0
    if sys.argv[1:2] == ["--k4-ablation"]:
        k4_ablation(smi)
        return 0
    sys.path.insert(0, str(HERE / "src"))
    phase_build()
    if sys.argv[1:2] == ["--lifecycle"]:
        phase_lifecycle(smi, {})
        return 0
    if sys.argv[1:2] == ["--disagg"]:
        phase_disagg(smi, {})
        return 0
    if sys.argv[1:2] == ["--xlstm"]:
        phase_xlstm(smi, {}, None)
        return 0
    if sys.argv[1:2] == ["--families"]:
        phase_families(smi, {})
        return 0
    if sys.argv[1:2] == ["--train"]:
        phase_train(smi, {})
        return 0
    if sys.argv[1:2] == ["--sharded"]:
        phase_sharded(smi, {})
        return 0
    if sys.argv[1:2] == ["--train-sharded"]:
        phase_train_sharded(smi, {})
        return 0
    if sys.argv[1:2] == ["--mesh"]:
        phase_process_mesh(smi, {})
        return 0
    if sys.argv[1:2] == ["--kernels"]:
        phase_kernels()
        return 0
    main_cases = phase_kernels()
    bench_launches = phase_bench(smi)
    ref: dict = {}
    launches = phase_engine(smi, ref)
    phase_kvcache(smi, launches)
    phase_spec(smi, launches)
    phase_models(smi, launches)
    phase_lifecycle(smi, launches)
    phase_disagg(smi, launches)
    phase_xlstm(smi, launches, ref.get("zamba2-1.2b"))
    phase_families(smi, launches)
    phase_train(smi, launches)
    phase_sharded(smi, launches)
    phase_train_sharded(smi, launches)
    phase_process_mesh(smi, launches)
    # K3 serves whisper's cross-attention decode (phase 13) beside the bench
    serving_k3 = launches.get("flash_decode", 0)
    launches["flash_decode"] = serving_k3 + bench_launches["flash_decode"]
    meta = {
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:130"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:77"),
        "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:48"),
        "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan.py:73"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = main_cases[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r.get("library_ms"),
                        "graph_ms": r.get("graph_ms")})
        if name == "paged_attention":    # its verify mode, 64 rows
            v = main_cases["paged_attention_verify"]
            kernels[-1].update({
                "launches_windowed": launches.get(
                    "paged_attention windowed", 0),
                "verify_max_abs_err": v["max_abs_err"],
                "verify_ms": v["ms"], "verify_graph_ms": v["graph_ms"],
                "verify_bound_ms": v["bound_ms"],
                "verify_plain_ms": v["plain_ms"]})
        if name == "flash_attention":    # non-causal: whisper's encoder
            for key, tag in (("flash_attention encoder", "encoder"),
                             ("flash_attention cross", "cross")):
                c = main_cases[key]
                kernels[-1].update({
                    f"{tag}_max_abs_err": c["max_abs_err"],
                    f"{tag}_ms": c["ms"], f"{tag}_plain_ms": c["plain_ms"],
                    f"{tag}_bound_ms": c["bound_ms"],
                    f"{tag}_bound_by": c["bound_by"],
                    f"{tag}_library_ms": c.get("library_ms")})
            kernels[-1]["launches_noncausal"] = \
                launches["flash_attention noncausal"]
        if name == "flash_decode":    # whisper's cross decode, the bench
            c = main_cases["flash_decode serving"]
            kernels[-1].update({
                "launches_serving": serving_k3,
                "launches_bench": bench_launches["flash_decode"],
                "serving_max_abs_err": c["max_abs_err"],
                "serving_ms": c["ms"], "serving_graph_ms": c["graph_ms"],
                "serving_plain_ms": c["plain_ms"],
                "serving_bound_ms": c["bound_ms"],
                "serving_bound_by": c["bound_by"],
                "serving_library_ms": c.get("library_ms")})
        if name == "ssm_scan":    # its decode route, the step kernel
            d = main_cases["ssm_scan_decode"]
            kernels[-1].update({
                "launches_chunk": launches["ssm_scan chunk"],
                "launches_step": launches["ssm_scan step"],
                "decode_ms": d["ms"],
                "decode_graph_ms": d["graph_ms"],
                "decode_bound_ms": d["bound_ms"]})
    print(f"[done] every phase passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
