"""Profiling, the program's own spans and counters, and the card's
figures (twin of ``spmm_denseblock_tpu/utils/profiling.py``, which has
no spans or counters).

- ``trace(logdir)``: a ``torch.profiler`` run over the block (the host
  and, on a machine with a GPU, the card), exported as a Chrome trace
  into `logdir` (open it in Perfetto or chrome://tracing). Each kernel
  launch of ``ops/_kernels`` shows as a range named by its C entry
  (``sdb_...``) with the device kernel under it. Program tracing is on
  over the block: the program's spans go into the same trace as
  complete events (category ``sdb``) over the launches they made, its
  counters into one counter event ``sdb.counts`` at the end.
- ``enable(on)``, ``enabled()``: the switch of program tracing, off by
  default; nothing in the package turns it on but ``trace()``.
- ``span(name, **attrs)``: a context that records a ``Span`` while
  tracing is on. Its clock is ``time.time_ns()`` and its thread the
  native thread id, the clock and the ``tid`` of a ``torch.profiler``
  Chrome trace that records host activity: a span lands on its timeline
  at ``ts = (start_ns - baseTimeNanoseconds) / 1e3`` µs, over the
  runtime calls it made (a trace of CUDA activity alone gives those
  calls another thread id). Off, it returns one shared no-op context
  and reads no clock.
- ``count(name, n)``: adds `n` to a counter while tracing is on.
- ``take()``: the recorded spans, the counters and the number of spans
  dropped past the buffer's cap, cleared.
- ``annotate(name)``: a named range on that timeline
  (``torch.profiler.record_function``).
- ``device_info()``: the device's kind and memory for bench records.
- ``roofline(flops, bytes, secs)``: achieved rates and, given peaks,
  the fraction of the roofline; ``PEAK_OPS_S`` and ``HBM_BYTES_S`` are
  the H100's.

The SpMM route's spans and counters (``ops/plan``, ``ops/dispatch``):
``sdb.<impl>`` around each leaf plan's call (``<impl>`` the ``PLANNERS``
key of the planner that built it), ``sdb.sum`` around a sum of plans
(the hybrid's two parts nest in it), ``sdb.backward`` around a grad
plan's Aᵀ run in autograd's backward (on autograd's thread), and
``sdb.route`` around ``auto``'s decision in ``spmm_plan`` (attributes
``impl`` and ``threshold``); the counters ``sdb.nnz/<impl>`` (stored
nonzeros of A) and ``sdb.positions/<impl>`` (element positions the
layout computes) at each leaf call, and ``sdb.call_values/<impl>`` (the
values a values="call" leaf was given, nnz x heads) at each such call.
The models' spans: ``sdb.gat_scores`` around each GAT layer's node and
edge scores and their softmax (``models/gat``).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, NamedTuple, Optional

import torch

# NVIDIA H100 80GB HBM3 (SXM) published peaks, dense, at the 700 W power
# limit: device memory bytes/s, and operations/s by the operands' type
# ("high", bf16x3, counts three bf16 products on the bf16 tensor cores;
# exact f32 is FFMA: the 1e-4 gate rules out TF32). A card set below
# 700 W runs below them.
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "high": 989e12, "bf16": 989e12, "int8": 1979e12}

# -- program tracing -----------------------------------------------------------

SPAN_CAP = 1 << 16  # spans kept; past it the oldest go


class Span(NamedTuple):
    """One closed span: `index` numbers spans in the order they opened,
    over the process; `parent` is the index of the innermost span open
    on the same thread when it opened, or -1; `thread` the native thread
    id; times in ``time.time_ns()``."""

    index: int
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: int
    attrs: dict


_on = False
_lock = threading.Lock()
_spans: collections.deque = collections.deque(maxlen=SPAN_CAP)  # plain tuples
_dropped = 0
_counts: Dict[str, int] = {}
_ids = itertools.count()
_open = threading.local()  # .stack: this thread's open spans; .thread: its id


def enable(on: bool = True) -> bool:
    """Turn program tracing on or off; returns the previous state."""
    global _on
    prev, _on = _on, bool(on)
    return prev


def enabled() -> bool:
    return _on


class _NoSpan:
    """The span of tracing off: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "attrs", "index", "parent", "start_ns", "stack", "thread")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        try:
            self.stack, self.thread = _open.stack, _open.thread
        except AttributeError:  # the thread's first span: its id once
            self.stack = _open.stack = []
            self.thread = _open.thread = threading.get_native_id()
        self.parent = self.stack[-1] if self.stack else -1
        self.index = next(_ids)
        self.stack.append(self.index)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.time_ns()
        self.stack.pop()
        _record((self.index, self.name, self.start_ns, end_ns, self.thread,
                 self.parent, self.attrs))
        return False

    def set(self, **attrs):
        """Attributes known only inside the span (a decision's outcome)."""
        self.attrs.update(attrs)


def _record(span: tuple) -> None:
    global _dropped
    with _lock:
        if len(_spans) == _spans.maxlen:
            _dropped += 1
        _spans.append(span)


def span(name: str, **attrs):
    """A context recording a Span named `name` with `attrs` while tracing
    is on; off, the shared no-op context. Both have ``set(**attrs)``."""
    if not _on:
        return _NO_SPAN
    return _OpenSpan(name, attrs)


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name` while tracing is on."""
    if _on:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def take() -> Dict:
    """{"spans": the closed spans in the order they opened, "counts":
    the counters, "dropped": spans lost past the cap}, and clear them."""
    global _dropped
    with _lock:
        spans, counts, dropped = sorted(_spans), dict(_counts), _dropped
        _spans.clear()
        _counts.clear()
        _dropped = 0
    return {"spans": [Span._make(s) for s in spans], "counts": counts,
            "dropped": dropped}


def _chrome_events(taken: Dict, base_ns: int, end_us: float) -> list:
    """The program's spans as Chrome complete events on the profiler's
    timeline (µs since `base_ns`), its counters as one counter event at
    `end_us`."""
    pid = os.getpid()
    out = [{"ph": "X", "cat": "sdb", "name": s.name, "pid": pid, "tid": s.thread,
            "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"index": s.index, "parent": s.parent, **s.attrs}}
           for s in taken["spans"]]
    if taken["counts"]:
        out.append({"ph": "C", "cat": "sdb", "name": "sdb.counts", "pid": pid,
                    "tid": 0, "ts": end_us, "args": taken["counts"]})
    return out


@contextlib.contextmanager
def trace(logdir: str, host: bool = False):
    """Profile the block; on exit write ``trace_<pid>_<ns>.json`` into
    `logdir`, with the program's spans and counters of the block (program
    tracing is on over it; what it recorded before the block is taken
    with them). The card's activity is traced where torch sees a GPU.
    `host` is JAX's argument, unused there too."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prev = enable(True)
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        enable(prev)
    taken = take()
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    end_us = max((float(e["ts"]) + float(e.get("dur", 0.0)) for e in events
                  if "ts" in e), default=0.0)
    events.extend(_chrome_events(taken, int(doc["baseTimeNanoseconds"]), end_us))
    with open(path, "w") as f:
        json.dump(doc, f, default=repr)


def annotate(name: str):
    """Scoped trace annotation (a named range on the trace timeline)."""
    return torch.profiler.record_function(name)


def device_info(device=None) -> Dict:
    """The JAX record's keys for `device` (None: the card): backend
    ("cuda" or "cpu"), n_devices, platform ("gpu" or "cpu"),
    device_kind, and on the card bytes_limit (its memory) and
    bytes_in_use (what torch holds there)."""
    # imported here: ops imports this module for its spans
    from spmm_denseblock_tpu_torch.ops._device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"backend": "cpu", "n_devices": 1, "platform": "cpu",
                "device_kind": "cpu"}
    return {
        "backend": "cuda",
        "n_devices": torch.cuda.device_count(),
        "platform": "gpu",
        "device_kind": torch.cuda.get_device_name(dev),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
        "bytes_in_use": torch.cuda.memory_allocated(dev),
    }


def roofline(
    flops: float,
    bytes_moved: float,
    secs: float,
    peak_flops: Optional[float] = None,
    peak_bw: Optional[float] = None,
) -> Dict:
    """Achieved rates + (optionally) fraction of the machine roofline."""
    out = {
        "gflops": flops / secs / 1e9,
        "gb_s": bytes_moved / secs / 1e9,
        "intensity_flop_per_byte": flops / max(bytes_moved, 1.0),
        "ms": secs * 1e3,
    }
    if peak_flops and peak_bw:
        ridge = peak_flops / peak_bw
        bound = "compute" if out["intensity_flop_per_byte"] >= ridge else "memory"
        attainable = min(peak_flops, peak_bw * out["intensity_flop_per_byte"])
        out.update(
            bound=bound,
            frac_of_roofline=(flops / secs) / attainable,
        )
    return out
