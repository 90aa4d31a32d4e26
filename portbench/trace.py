"""From ``torch.profiler`` Chrome traces to the quantities the per-layer
metrics read. A traced run profiles two slices of its window:

- the device slice, with the profiler's CUDA activity only (kernels,
  copies, fills and the runtime calls that launched them, without a
  record of every host operation, whose cost would starve the card of
  work on a host-heavy route): ``device_summary`` gives the busy time,
  the window and the breakdown;
- the span slice, with host operations and the benchmark's spans:
  ``route_summary`` gives each request's or step's device time in and
  outside the SpMM route.

Device time is the union of kernel, memcpy and memset intervals only:
the ranges that ``record_function`` opens (the benchmark's ``pb.*``
spans and the port's ``sdb_<entry>`` launcher ranges) show on the
device's timeline too, as ``gpu_user_annotation``, and are not device
work.

A device operation belongs to the request or step whose ``pb.request``
/ ``pb.step`` span holds the runtime call that launched it (the same
correlation id), and to the SpMM route when that call lies in a
``pb.spmm`` span or in the autograd backward of an operation that ran
inside one (matched by the profiler's sequence numbers).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
BACKWARD = "autograd::engine::evaluate_function"
TOP = 10


def load(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def read_and_remove(path: str, summary, *args) -> Dict:
    try:
        return summary(load(path), *args)
    finally:
        os.remove(path)


def _complete(events, cats):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def _interval(e):
    t = float(e["ts"])
    return t, t + float(e.get("dur", 0.0))


def _merge(iv: List[tuple]) -> np.ndarray:
    """Sorted, disjoint union of [start, end] intervals, as a (k, 2) array."""
    out = []
    for s, t in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return np.asarray(out, dtype=np.float64).reshape(-1, 2)


def _inside(merged: np.ndarray, t: np.ndarray) -> np.ndarray:
    """For each time in t, the index of the merged interval holding it,
    or -1."""
    if merged.shape[0] == 0:
        return np.full(t.shape, -1)
    i = np.searchsorted(merged[:, 0], t, side="right") - 1
    ok = (i >= 0) & (t <= merged[np.clip(i, 0, None), 1])
    return np.where(ok, i, -1)


def device_summary(events: List[dict]) -> Dict:
    """window_s (from the first runtime call or device operation to the
    end of the last one: the slice ends in a synchronize), busy_s (the
    device union inside it) and the breakdown: the device operations
    that took most time, and the longest idle gaps, each named by the
    last runtime call the host made before it began and the next one."""
    dev = _complete(events, DEVICE_CATS)
    rt = sorted(_complete(events, RUNTIME_CATS), key=lambda e: float(e["ts"]))
    spans = [_interval(e) for e in dev + rt]
    if not dev or not spans:
        return {"window_s": 0.0, "busy_s": 0.0, "on_device": False,
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    w0, w1 = min(s for s, _ in spans), max(t for _, t in spans)
    busy = _merge([_interval(e) for e in dev])
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e.get("dur", 0.0))
    ends = [w0] + [x for s, t in busy for x in (s, t)] + [w1]
    gaps = sorted(((ends[i], ends[i + 1]) for i in range(0, len(ends), 2)
                   if ends[i + 1] > ends[i]), key=lambda g: g[0] - g[1])[:TOP]
    starts = np.asarray([float(e["ts"]) for e in rt])

    def around(s, t):
        i = int(np.searchsorted(starts, s, side="right")) - 1
        j = i + 1
        before = rt[i]["name"] if i >= 0 else "start"
        after = rt[j]["name"] if j < len(rt) else "end"
        return f"{before} -> {after}"

    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": float((busy[:, 1] - busy[:, 0]).sum()) / 1e6,
        "on_device": True,
        "breakdown": {
            "device_ops": [[k, v / 1e6] for k, v in
                           sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[around(s, t), (t - s) / 1e6] for s, t in gaps],
        },
    }


def route_summary(events: List[dict], unit: str, spmm: str = "pb.spmm") -> Dict:
    """units (the spans named `unit`), spmm_s and dense_s (seconds of
    device time that those units launched, in and outside the SpMM
    route)."""
    ann = _complete(events, ("user_annotation",))
    unit_spans = [_interval(e) for e in ann if e["name"] == unit]
    units = _merge(unit_spans)
    spmm_spans = [e for e in ann if e["name"] == spmm]
    ops = _complete(events, ("cpu_op",))
    # the sequence numbers of the operations inside a pb.spmm span (same
    # thread): their backward evaluations belong to the route too
    seqs = set()
    for tid in {e.get("tid") for e in spmm_spans}:
        spans = _merge([_interval(e) for e in spmm_spans if e.get("tid") == tid])
        fwd = [e for e in ops if e.get("tid") == tid
               and "Sequence number" in e.get("args", {})
               and not e["name"].startswith(BACKWARD)]
        if not fwd:
            continue
        iv = np.asarray([_interval(e) for e in fwd])
        at = _inside(spans, iv[:, 0])
        ok = (at >= 0) & (iv[:, 1] <= spans[np.clip(at, 0, None), 1])
        seqs.update(fwd[i]["args"]["Sequence number"] for i in np.nonzero(ok)[0])
    route = _merge([_interval(e) for e in spmm_spans]
                   + [_interval(e) for e in ops if e["name"].startswith(BACKWARD)
                      and e.get("args", {}).get("Sequence number") in seqs])
    launch = {e["args"]["correlation"]: float(e["ts"])
              for e in _complete(events, RUNTIME_CATS)
              if "correlation" in e.get("args", {})}
    dev = _complete(events, DEVICE_CATS)
    # an operation launched before the profiler started has no launch
    # event (nan) and belongs to no unit
    t = np.asarray([launch.get(e.get("args", {}).get("correlation"), np.nan)
                    for e in dev], dtype=np.float64)
    dur = np.asarray([float(e.get("dur", 0.0)) for e in dev], dtype=np.float64)
    known = ~np.isnan(t)
    in_unit = np.zeros(len(dev), dtype=bool)
    in_route = np.zeros(len(dev), dtype=bool)
    in_unit[known] = _inside(units, t[known]) >= 0
    in_route[known] = _inside(route, t[known]) >= 0
    return {
        "units": len(unit_spans),
        "spmm_s": float(dur[in_unit & in_route].sum()) / 1e6,
        "dense_s": float(dur[in_unit & ~in_route].sum()) / 1e6,
    }
