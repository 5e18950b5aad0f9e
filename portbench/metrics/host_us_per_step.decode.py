"""host_us_per_step: the engine's host time (schedule, faults, the config
buffer, the overlap window: ``EngineTiming.host_s``) per engine tick over
the traced window."""


def read(w):
    steps = w.delta("steps")
    return 1e6 * w.delta("host_s") / steps if steps else None
