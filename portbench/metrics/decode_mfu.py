"""decode_mfu: the model FLOPs of the window (every decode token at its
context, every prompt prefilled in it; ``harness.counts``) over the
window's wall time x 495 TF/s, the H100's dense TF32 peak (the fastest
unit that takes fp32 operands), in %."""
from harness import counts as C


def read(w):
    fl = w.sum_over_ctx(lambda ctx: C.decode_flops(w.config, ctx))
    fl += sum(C.prefill_flops(w.config, S) for S in w.prefilled())
    return 100.0 * fl / (w.seconds * C.TF32_FLOPS) if fl else None
