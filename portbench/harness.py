"""One run of one cell: set up, warm up, measure for ``--seconds``, check
the answers against the plain reference, print one JSON line.

What a cell runs is found by name (``spec.py``): the configuration's
model (``models/<model>.py``, the yardstick's side; ``systems/<model>.py``,
the program's) and the mix's kind (``kinds/<kind>.py``: ``serve``, a
closed loop of callers; ``train``, full-batch steps under Adam).

``--trace 0`` reports the cell's end-to-end metrics. ``--trace 1`` runs
the same window (host-clock readings from all but its last ``SLICE_S``
seconds), profiles that last part (see ``trace.py``) and reports the
per-layer metrics, each read by its own module under
``portbench/metrics/``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional

from portbench import graphgen, spec, trace, work

# top-level module names that may not be loaded in a run, compared whole
JAX_NAMES = ("jax", "jaxlib", "flax", "spmm_denseblock_tpu")
CACHE = Path(__file__).resolve().parent / "cache"
SLICE_S = 2.0       # the profiled end of a traced window (two slices)


@dataclasses.dataclass
class Hook:
    """The CPU dry run: the whole plumbing on the CPU at a tiny size.
    Its line carries no metric (a CPU time is no device metric); what the
    readers would report lands in `metrics` for the tests. `patch`, if
    given, breaks the timed path: patch(system) after set-up."""
    root: Path = spec.ROOT
    scale: float = 0.005
    patch: Optional[Callable] = None
    metrics: Dict = dataclasses.field(default_factory=dict)
    result: Dict = dataclasses.field(default_factory=dict)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def loaded_jax() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(JAX_NAMES))


def say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def sync(device):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


# -- inputs from the seed ------------------------------------------------------


def make_inputs(config: dict, mix: dict, n: int, seed: int, device,
                model, kind) -> Dict:
    """The model's weights and the kind's data, drawn on the device from
    one generator in a few large calls; `leaves` are the weights in the
    model's order."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    params = model.init_params(config, g, device)
    return {"params": params, "leaves": model.leaves(params),
            **kind.data(config, mix, n, g, device)}


# -- the run -------------------------------------------------------------------


def _device(cell, hook):
    """'cuda', or None (and why, on stderr) where the cell's cards are not
    there. The CPU dry run is 'cpu'."""
    import torch

    if hook is not None:
        return "cpu"
    if not torch.cuda.is_available():
        say("portbench: no CUDA device (torch.cuda.is_available() is false); "
            "the benchmark runs on the card only")
        return None
    if torch.cuda.device_count() < cell.chips:
        say(f"portbench: {cell.name} needs {cell.chips} cards, "
            f"torch sees {torch.cuda.device_count()}")
        return None
    return "cuda"


def _profiler(system, device):
    """traced(fn, unit): fn (which serves or steps for a given number of
    seconds) for two slices of SLICE_S / 2 each under torch.profiler,
    the device slice with CUDA activity only, then the span slice with
    the host's operations and the system's spans. Returns
    trace.device_summary's dict updated with trace.route_summary's."""
    from torch.profiler import ProfilerActivity, profile

    def one(activities, fn, spans):
        path = CACHE / "traces" / f"trace-{os.getpid()}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        system.tracing = spans
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                with profile(activities=activities) as prof:
                    fn(SLICE_S / 2)
                    sync(device)
                prof.export_chrome_trace(str(path))
        finally:
            system.tracing = False
        return str(path)

    def traced(fn, unit):
        cpu, cuda = ProfilerActivity.CPU, ProfilerActivity.CUDA
        out = {"window_s": 0.0, "busy_s": 0.0, "on_device": False,
               "breakdown": {"device_ops": [], "idle_gaps": []}}
        if device == "cuda":
            out = trace.read_and_remove(one([cuda], fn, False), trace.device_summary)
        acts = [cpu, cuda] if device == "cuda" else [cpu]
        out.update(trace.read_and_remove(one(acts, fn, True), trace.route_summary,
                                         unit))
        return out

    return traced


def _reading(cell, model, system, out, n, nnz, device) -> Dict:
    """What the per-layer readers read."""
    is_train = cell.mix["kind"] == "train"
    prec = cell.mix.get("precision", "f32")
    return {
        "kind": cell.mix["kind"],
        "on_device": device == "cuda",
        "prep_s": system.prep_s,
        "plan_s": system.plan_s,
        "enqueue_ms": out.get("enqueue_ms"),
        "units_per_s": out.get("units_per_s"),
        "model_flops": model.flops(cell.config, n, nnz, is_train),
        "spmm_bound_s": model.spmm_bound_s(cell.config, n, nnz, is_train, prec),
        "peak_ops_s": work.PEAK_OPS_S[prec],
        "trace": out.get("trace"),
    }


def main(argv=None, hook: Optional[Hook] = None, t_start: Optional[float] = None) -> int:
    t_main = time.perf_counter()
    t_start = t_main if t_start is None else t_start
    args = parse(argv)
    root = hook.root if hook is not None else spec.ROOT
    try:
        cell = spec.load_cell(args.workload, root)
    except (KeyError, LookupError) as e:
        say(f"portbench: {e}")
        return 2
    model = spec.model(cell.config["model"], root)
    kind = spec.kind(cell.mix["kind"], root)
    import torch

    device = _device(cell, hook)
    if device is None:
        return 2
    # the configurations state exact float32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    n, edges = graphgen.load_edges(cell.config["graph"],
                                   hook.scale if hook is not None else 1.0)
    t_load = time.perf_counter() - t0
    phases = {"imports": t_main - t_start, "device": t0 - t_main, "graph": t_load}
    t0 = time.perf_counter()
    adapter = spec.system(cell.config["model"], root)
    phases["port import"] = time.perf_counter() - t0

    if spec.ROOT not in adapter.PROGRAM.parents:
        say(f"portbench: the program was imported from {adapter.PROGRAM}, "
            "outside this checkout")
        return 2
    system = adapter.System(cell.config, cell.mix, n, edges, device, t_load)
    phases.update(prep=system.prep_s - t_load, plan=system.plan_s)
    t0 = time.perf_counter()
    inputs = make_inputs(cell.config, cell.mix, n, args.seed, device, model, kind)
    sync(device)
    t1 = time.perf_counter()
    phases["inputs"] = t1 - t0
    if hook is not None and hook.patch is not None:
        hook.patch(system)
    out = kind.run(cell, system, inputs, args, device, t_start,
                   _profiler(system, device))
    phases["warm-up"] = t_start + out["setup_s"] - t1
    say("setup " + " ".join(f"{k} {v:.3f}" for k, v in phases.items())
        + f" total {out['setup_s']:.3f} s")

    found = loaded_jax()
    if found:
        say(f"portbench: the run loaded {', '.join(found)}; the port may not")
        return 3
    dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if device == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": cell.chips,
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    nnz = len(edges) + n
    reading = _reading(cell, model, system, out, n, nnz, device)
    del system
    if device == "cuda":
        torch.cuda.empty_cache()
    ok, failed, checks = kind.check(cell, model, out, inputs, edges, n)

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            value = spec.reader(m["name"], root)(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = out["trace"]
        if device == "cuda":
            dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out[m["name"]], "unit": m["unit"]}
    result = {"correct": bool(ok), "attempted": int(out["attempted"]),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if args.trace and device == "cuda":
        result["breakdown"] = out["trace"]["breakdown"]
    if hook is not None:  # no CPU number goes out under a metric's name
        hook.metrics = metrics
        result["metrics"] = {}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    for c in checks:
        say(f"check {c['name']} {c['value']!r} limit {c['limit']!r}")
    if hook is not None:
        hook.result = result
    print(json.dumps(result), flush=True)
    return 0
