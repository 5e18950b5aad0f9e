"""launch_us.decode: the host time of a horizon's launch (the ``allow``
copy and the graph replay, or the eager body: ``EngineTiming.launch_s``)
over the horizons dispatched in the window (``device_syncs``). A program
without the counter reads nothing."""


def read(w):
    if "launch_s" not in w.timing1:
        return None
    syncs = w.delta("device_syncs")
    return 1e6 * w.delta("launch_s") / syncs if syncs else None
