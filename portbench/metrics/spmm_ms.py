"""spmm_ms: device milliseconds a request or step in the SpMM route (the
operations launched inside the pb.spmm spans and their autograd
backward), from the profiled slice."""


def read(r):
    t = r["trace"]
    if not r["on_device"] or t is None or not t["units"] or t["spmm_s"] <= 0:
        return None
    return 1e3 * t["spmm_s"] / t["units"]
