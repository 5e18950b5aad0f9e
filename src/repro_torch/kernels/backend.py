"""Device resolution and the ``KernelConfig`` threaded through the stack.

One knob object rides from ``launch.serve`` / ``serving.EngineConfig``
through ``models.model.Runtime`` down to the kernel call sites
(``kernels/ops.py``, ``core/itpp.py``), as in ``repro/kernels/backend.py``.

Dispatch is by tensor device, never by a fallback: each kernel wrapper runs
its plain PyTorch version for a CPU tensor and launches its CUDA kernel for
a CUDA tensor, raising when the card is not Hopper or the kernel did not
build. ``KernelConfig(use_kernels=False)`` asks for the plain paths
explicitly (the gather-then-dense decode and the chunked online-softmax
prefill), which is what the kernels are compared against.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


def on_hopper() -> bool:
    """True when a CUDA card of compute capability 9.0 (H100/H200) is
    visible — the only target ``csrc/`` is compiled for (``sm_90a``)."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability() == (9, 0))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for something else. Asking for ``cuda`` without a card raises — a run
    never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch paths")
    return dev


def require_hopper(t: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` lies on a compute-capability 9.0 card."""
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(f"{what}: the CUDA kernel is built for sm_90a "
                           f"(Hopper); this card reports sm_{cap[0]}{cap[1]}")


def require_aligned(what: str, D: int, tensors: dict) -> None:
    """Raise unless each tensor's rows of ``D`` values are whole 16-byte
    copies and its base address is 16-byte aligned: the kernels move rows
    with 16-byte asynchronous copies (TMA or ``cp.async``)."""
    for name, t in tensors.items():
        if D * t.element_size() % 16:
            raise ValueError(f"{what}: rows of D={D} {t.dtype} values are "
                             f"{D * t.element_size()} bytes, not a multiple "
                             "of 16")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


@dataclass(frozen=True)
class KernelConfig:
    """How attention executes.

    ``use_kernels``: ``None`` or True route decode and prefill attention
    through the kernel wrappers (CUDA kernel on a card, plain version on
    CPU tensors); False selects the plain reference paths explicitly.
    ``n_splits``: split-K partitions of the decode page axis inside one
    kernel call — the intra-chip analogue of the paper's TCP token split.
    """
    use_kernels: bool | None = None
    n_splits: int = 1

    @property
    def enabled(self) -> bool:
        return self.use_kernels is None or bool(self.use_kernels)


def decode_hbm_bytes(ctx_tokens: float, n_kv_heads: int, d_head: int,
                     bytes_per_el: int, n_layers: int = 1) -> float:
    """Modeled KV bytes one decode step streams from device memory for a
    request at context ``ctx_tokens``: K and V read once across the live
    context — the bound of the paged decode kernel."""
    return 2.0 * ctx_tokens * n_kv_heads * d_head * bytes_per_el * n_layers
