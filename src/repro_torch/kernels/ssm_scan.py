"""Mamba2 chunked selective scan: the CUDA kernel and its plain version.

Port of ``repro/kernels/ssm_scan.py`` (the Pallas TPU kernel ``_kernel`` /
``ssm_chunk_scan``): chunkwise gated linear attention with a ``[N, P]``
fp32 state carried across chunks, seeded from ``state`` and returned, and
``valid_len`` tails masked into identity steps. It carries every Mamba2
mixer of the model (``models/ssm.mamba_forward`` through
``kernels/ops.mamba_mixer``): prefill at chunk ``min(128, S)``, chunked
prefill at the engine's chunk, and decode at ``S = chunk = 1``.

* CUDA tensors launch one of the two kernels of ``csrc/ssm_scan.cu``,
  picked by the chunk (see the note in the source): for ``chunk > 1``
  (prefill, chunked prefill) the chunk kernel, one thread block per (batch
  row, head, slice of P; ``default_p_slice``) running the chunk loop with
  the four products on the TF32 tensor cores; for ``chunk == 1`` (the decode
  step) the step kernel, which streams the ``[N, P]`` state once. Each
  launch is counted in ``ssm_chunk_scan.launches``, and by route in
  ``ssm_chunk_scan.launches_chunk`` / ``ssm_chunk_scan.launches_step``.
* CPU tensors take the plain version, ``ssm_chunk_scan_plain``: the same
  per-chunk arithmetic in dense PyTorch.

Unlike the TPU kernel, this one also carries the normalizer ``n`` that
``chunked_gla`` accumulates (Mamba2 never reads it), so the model's state
equals the JAX state leaf for leaf; and it reads q, k and v through their
strides, so Mamba2's head-broadcast q/k (stride 0 over heads) are never
copied per head.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import require_hopper
from repro_torch.models.ssm import mask_log_gates_tail

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128
MAX_SMEM = 232448          # dynamic shared memory a block may use (bytes)


def default_p_slice(P: int, bh: int, n_sm: int) -> int:
    """P columns a chunk-kernel block owns, for ``bh`` = B x H (batch row,
    head) pairs on a card of ``n_sm`` SMs: 64, unless P fits in 32 or the
    blocks of 64 columns would fill at most half the SMs (one row of
    zamba2's slot prefill: 64 blocks on the H100's 132), then 32. Each
    block computes its rows' scores q k^T in full, so 32 columns a block
    at P = 64 computes them twice: on the H100 that measured slower from
    B = 2 (128 blocks) up, for both input types, and faster at B = 1
    (``chip_smoke.py`` phase 3 times both)."""
    if P <= 32 or 2 * bh * -(-P // 64) <= n_sm:
        return 32
    return 64


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib():
    lib = build.load("ssm_scan")
    fn = lib.ssm_chunk_scan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.ssm_chunk_scan_smem.restype = ctypes.c_longlong
        lib.ssm_chunk_scan_smem.argtypes = [ctypes.c_int] * 5
    return lib


def _state_in(state, B, H, N, P, device):
    """(C0, n0) as fp32 contiguous tensors, or (None, None) for a fresh
    sequence."""
    if state is None:
        return None, None
    C0, n0 = state
    if tuple(C0.shape) != (B, H, N, P) or tuple(n0.shape) != (B, H, N):
        raise ValueError(f"ssm_chunk_scan: state shapes {tuple(C0.shape)} / "
                         f"{tuple(n0.shape)} do not match [B, H, N, P] = "
                         f"{(B, H, N, P)}")
    return (C0.to(device=device, dtype=torch.float32).contiguous(),
            n0.to(device=device, dtype=torch.float32).contiguous())


def ssm_chunk_scan_plain(q, k, v, log_a, log_g, *, chunk: int, state=None):
    """The kernel's function in dense PyTorch, chunk by chunk (=
    ``models.ssm.chunked_gla(normalize=False)``). Returns (y [B, S, H, P],
    (C [B, H, N, P], n [B, H, N])), all fp32."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    dev = q.device
    C, n = _state_in(state, B, H, N, P, dev)
    C = torch.zeros((B, H, N, P), device=dev) if C is None else C
    n = torch.zeros((B, H, N), device=dev) if n is None else n
    idx = torch.arange(chunk, device=dev)
    below = (idx[:, None] >= idx[None, :])[None, None]          # [1,1,i,j]
    ys = []
    for t0 in range(0, S, chunk):
        # [B, H, c, *] per (b, h), as one block of the kernel sees it
        qb, kb, vb = (x[:, t0:t0 + chunk].transpose(1, 2).float()
                      for x in (q, k, v))
        la, lg = (x[:, t0:t0 + chunk].transpose(1, 2).float()
                  for x in (log_a, log_g))
        bcum = torch.cumsum(la, dim=-1)                          # [B, H, c]
        btot = bcum[..., -1:]
        wlog = bcum[..., :, None] - bcum[..., None, :] + lg[..., None, :]
        w = torch.where(below, torch.exp(wlog.clamp(-1e30, 60.0)),
                        torch.zeros_like(wlog))
        scores = (qb @ kb.transpose(-1, -2)) * w
        y = scores @ vb + torch.exp(bcum)[..., None] * (qb @ C)
        ys.append(y.transpose(1, 2))
        ks = kb * torch.exp((btot - bcum + lg).clamp(-1e30, 60.0))[..., None]
        carry = torch.exp(btot)                                  # [B, H, 1]
        C = C * carry[..., None] + ks.transpose(-1, -2) @ vb
        n = n * carry + ks.sum(dim=-2)
    return torch.cat(ys, dim=1), (C, n)


def _check(q, k, v, log_a, log_g, chunk):
    B, S, H, N = q.shape
    P = v.shape[-1]
    if k.shape != q.shape or tuple(v.shape[:3]) != (B, S, H) or \
            tuple(log_a.shape) != (B, S, H) or log_g.shape != log_a.shape:
        raise ValueError(f"ssm_chunk_scan: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} log_a "
                         f"{tuple(log_a.shape)} log_g {tuple(log_g.shape)}")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"ssm_chunk_scan: need 1 <= chunk <= {MAX_CHUNK} "
                         f"and S % chunk == 0; got S={S}, chunk={chunk}")
    return B, S, H, N, P


def _launch(q, k, v, log_a, log_g, *, chunk: int, state):
    require_hopper(q, "ssm_chunk_scan")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"ssm_chunk_scan: q/k/v must share float32 or "
                        f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    B, S, H, N, P = _check(q, k, v, log_a, log_g, chunk)
    lib = _lib()
    dt = _DTYPES[q.dtype]
    p_slice = default_p_slice(P, B * H, _sm_count(q.device.index or 0))
    smem = lib.ssm_chunk_scan_smem(dt, N, P, chunk, p_slice)
    if smem > MAX_SMEM:
        raise ValueError(f"ssm_chunk_scan: N={N}, P={P}, chunk={chunk} "
                         f"({q.dtype}, p_slice {p_slice}) needs {smem} B of "
                         f"shared memory a block (max {MAX_SMEM})")
    dev = q.device
    C0, n0 = _state_in(state, B, H, N, P, dev)
    # inside a captured decode horizon (serving/graphs.py) this clone and
    # the host stride array below are decided once, at capture: sound
    # because a graph's shapes and addresses never change between replays
    if C0 is not None and C0.data_ptr() % 16:
        C0 = C0.clone()        # the step kernel reads the state 16 B a load
    la = log_a.to(torch.float32).contiguous()
    lg = log_g.to(torch.float32).contiguous()
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=dev)
    C = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    n = torch.empty((B, H, N), dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(), *v.stride())
    p = build.ptr

    def opt(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())
    err = lib.ssm_chunk_scan(
        dt, p(q), p(k), p(v), p(la), p(lg), opt(C0), opt(n0), p(y), p(C),
        p(n), ctypes.cast(strides, ctypes.c_void_p), B, S, H, N, P, chunk,
        p_slice, build.stream_ptr(dev))
    build.check(err, "ssm_chunk_scan")
    ssm_chunk_scan.launches += 1
    if chunk == 1:
        ssm_chunk_scan.launches_step += 1
    else:
        ssm_chunk_scan.launches_chunk += 1
    return y, (C, n)


def ssm_chunk_scan(q, k, v, log_a, log_g, *, chunk: int = 128, state=None,
                   valid_len=None):
    """q, k [B, S, H, N]; v [B, S, H, P]; log_a/log_g [B, S, H].

    Returns (y [B, S, H, P] fp32, (C [B, H, N, P] fp32, n [B, H, N] fp32)).
    ``state`` = ``(C0, n0)`` carries the previous chunk's final state in
    (None = a fresh sequence); ``valid_len`` [B] makes
    positions >= valid_len[b] identity steps (their y rows are garbage).
    ``chunk`` is clamped to S, which it must then divide.
    """
    chunk = min(int(chunk), q.shape[1])
    if valid_len is not None:
        log_a, log_g = mask_log_gates_tail(log_a, log_g, valid_len)
    if q.device.type == "cpu":
        _check(q, k, v, log_a, log_g, chunk)
        return ssm_chunk_scan_plain(q, k, v, log_a, log_g, chunk=chunk,
                                    state=state)
    return _launch(q, k, v, log_a, log_g, chunk=chunk, state=state)


ssm_chunk_scan.launches = 0          # every launch
ssm_chunk_scan.launches_chunk = 0    # the chunk kernel (chunk > 1)
ssm_chunk_scan.launches_step = 0     # the step kernel (chunk == 1)
