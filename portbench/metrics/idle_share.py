"""idle_share: percent of the profiled slice in which no kernel, memcpy
or memset ran on the device (launcher ranges are not device work)."""


def read(r):
    t = r["trace"]
    if not r["on_device"] or t is None or not t["on_device"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
