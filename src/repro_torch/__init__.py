"""PyTorch + CUDA port of the PIMphony serving system (``repro``).

Mirrors ``repro``'s layout module for module. Decode attention reads the
paged pool through a hand-written Hopper kernel (``kernels/paged_attention``,
``csrc/paged_attention.cu``) and prefill attention goes through a
hand-written flash-attention kernel (``kernels/flash_attention``,
``csrc/flash_attention.cu``); CPU tensors take each kernel's plain PyTorch
version instead. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
