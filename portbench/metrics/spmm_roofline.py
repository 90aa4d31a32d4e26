"""spmm_roofline: percent of the SpMM route's device time that the
H100's roofline needs for the element-sparse CSR work of a request or
step (portbench/work.py), whatever route runs it."""


def read(r):
    t = r["trace"]
    if not r["on_device"] or t is None or not t["units"] or t["spmm_s"] <= 0:
        return None
    return 100.0 * r["spmm_bound_s"] / (t["spmm_s"] / t["units"])
