"""k1_roofline.decode: K1's bound over the traced window (every decode
token's live K/V, q and merged output once, per attention layer, at its
context; ``harness.counts.k1_work``) over the device time of
``paged_partials_kernel``, in %."""
from harness import counts as C


def read(w):
    if w.trace is None:
        return None
    sec, n = w.trace.kernel_s("paged_partials_kernel")
    if not n or sec <= 0:
        return None
    nbytes = w.sum_over_ctx(lambda ctx: C.k1_work(w.config, ctx)[0])
    flops = w.sum_over_ctx(lambda ctx: C.k1_work(w.config, ctx)[1])
    return 100.0 * C.bound_s(nbytes, flops, C.FP32_EXACT_FLOPS) / sec
