"""serial_host_us.decode: the engine's serial host path per horizon: the
host time of each dispatching tick from the end of its readback (or of its
overlap window) to the end of its dispatch, prefill and captures left out
(``EngineTiming.serial_s``), over the horizons dispatched in the window
(``device_syncs``: the window opens and closes on a quiesced engine). A
program without the counter reads nothing."""


def read(w):
    if "serial_s" not in w.timing1:
        return None
    syncs = w.delta("device_syncs")
    return 1e6 * w.delta("serial_s") / syncs if syncs else None
