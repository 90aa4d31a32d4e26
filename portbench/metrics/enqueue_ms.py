"""enqueue_ms: host milliseconds from a request's submit to the return of
its enqueue, the mean over the unprofiled part of the window."""


def read(r):
    return r["enqueue_ms"]
