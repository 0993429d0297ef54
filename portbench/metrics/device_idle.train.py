"""device_idle.train: 100 - the union of the device's activities over the
profiled step's wall time (host clock, synchronised), in %."""


def read(layer):
    sl = layer.get("slice")
    if not sl or sl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - sl["busy_s"] / sl["window_s"])
