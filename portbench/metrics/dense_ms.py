"""dense_ms: device milliseconds a request or step outside the SpMM
route (dense transforms, ReLU, permutations, loss, Adam), from the
profiled slice."""


def read(r):
    t = r["trace"]
    if not r["on_device"] or t is None or not t["units"] or t["dense_s"] <= 0:
        return None
    return 1e3 * t["dense_s"] / t["units"]
