"""attn_share: percent of a request's device time spent in the edge
attention (the operations launched inside the pb.spmm spans: scores,
softmax and the valued aggregation) against all of its device time,
100 · spmm_s / (spmm_s + dense_s), from the profiled slice."""


def read(r):
    t = r["trace"]
    if not r["on_device"] or t is None or not t["units"] or t["spmm_s"] <= 0:
        return None
    return 100.0 * t["spmm_s"] / (t["spmm_s"] + t["dense_s"])
