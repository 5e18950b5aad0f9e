"""Back-compat shim, as ``repro/core/engine.py``: the decode engine lives
in ``repro_torch.serving`` (``serving.engine`` orchestration, ``.prefill``
slot / batched / chunked strategies, ``.policies`` admission,
``.sampling`` samplers). Import from ``repro_torch.serving`` in new code.
"""
from repro_torch.serving.engine import DecodeEngine, EngineConfig  # noqa: F401

__all__ = ["DecodeEngine", "EngineConfig"]
