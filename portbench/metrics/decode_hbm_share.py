"""decode_hbm_share: the bytes the window's decode steps must move (the
weights once a step; each row's live K/V once a token;
``harness.counts``) over the window's wall time x 3.35 TB/s, in %."""
from harness import counts as C


def read(w):
    steps = w.delta("decode_steps")
    if not steps:
        return None
    nbytes = steps * C.weight_bytes(w.config) + w.sum_over_ctx(
        lambda ctx: C.kv_bytes(w.config, ctx))
    return 100.0 * nbytes / (w.seconds * C.HBM_BYTES_S)
