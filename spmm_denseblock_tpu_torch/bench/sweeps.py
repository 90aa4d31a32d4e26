"""Sweep grids + CLI (twin of ``spmm_denseblock_tpu/bench/sweeps.py``; the
reference's benchmark.py, which shells out to one CUDA binary per
configuration: here each grid point is a library call and the records
stream to JSONL).

Usage:
  python -m spmm_denseblock_tpu_torch.bench bsrmm   [--quick] [--out results.jsonl]
  python -m spmm_denseblock_tpu_torch.bench csrmm   [--quick]
  python -m spmm_denseblock_tpu_torch.bench graph   [--datasets ogbn-arxiv ...]
  python -m spmm_denseblock_tpu_torch.bench scaling [--devices 1 2 4]
  ... [--device cuda|cpu]   (default: the card; raises without a GPU)

The grids are the JAX package's. ``scaling``'s points are worlds of
ranks (``--devices``: their sizes, default 1, 2, 4); on one card they
share it, so read their retention, not scaling.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import traceback
from typing import Dict, Iterable, List

from spmm_denseblock_tpu_torch.bench import harness
from spmm_denseblock_tpu_torch.ops._device import resolve_device

# the reference's grids (benchmark.py:4-13, 23-33, 36-46) as the JAX
# package rescaled them: b in {32, 64, 128} (it repacks smaller blocks
# into 128-wide supertiles)
BSR_GRID = {
    "p": [2e-4, 2e-3, 2e-2],
    "b": [32, 64, 128],
    "dim": [64, 128, 256, 512],
    "impl": ["bsr_pallas", "bsr_xla"],
    # the reference's transB axis: transb=1 feeds a column-major operand
    # and times the copy to row-major with the SpMM
    "transb": [0, 1],
}
CSR_GRID = {
    "p": [2e-4, 2e-3, 2e-2],
    "dim": [64, 128, 256, 512],
    "impl": ["csr_xla", "bcoo"],
}
GRAPH_GRID = {
    "datasets": ["ogbn-arxiv", "ogbl-collab"],
    "strategy": ["original", "rcmk", "rabbit"],
    "dim": [16, 32, 64, 128],
    "impl": ["csr_xla", "bsr_pallas", "hybrid", "windowed"],
}


def _emit(rec: Dict, out):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        out.write(line + "\n")
        out.flush()


def _run_grid(cases: Iterable[Dict], fn, out) -> List[Dict]:
    """Runs fn(**case) for each case; a case that raises gives a record of
    its traceback and its arguments, and the sweep goes on."""
    done = []
    for kw in cases:
        try:
            rec = fn(**kw)
        except Exception:  # the sweep's boundary: record it and go on
            rec = {"error": traceback.format_exc(limit=3), **kw}
        _emit(rec, out)
        done.append(rec)
    return done


def sweep_bsrmm(quick=False, out=None, device=None):
    g = BSR_GRID
    cases = [
        dict(p=p, block_size=b, dim=d, impl=i, transb=t)
        for p in (g["p"][:1] if quick else g["p"])
        for b in (g["b"][-1:] if quick else g["b"])
        for d in (g["dim"][:1] if quick else g["dim"])
        for i in g["impl"]
        for t in (g["transb"][:1] if quick else g["transb"])
    ]
    return _run_grid(cases, functools.partial(harness.bench_synthetic_bsr,
                                              device=device), out)


def sweep_csrmm(quick=False, out=None, device=None):
    g = CSR_GRID
    cases = [
        dict(p=p, dim=d, impl=i, n_rows=1 << (12 if quick else 15))
        for p in (g["p"][:1] if quick else g["p"])
        for d in (g["dim"][:1] if quick else g["dim"])
        for i in g["impl"]
    ]
    return _run_grid(cases, functools.partial(harness.bench_synthetic_csr,
                                              device=device), out)


def sweep_graph(datasets=None, quick=False, out=None, scale=None, device=None):
    g = GRAPH_GRID
    datasets = datasets or g["datasets"]
    if scale is None:
        scale = 0.05 if quick else 1.0
    cases = [
        dict(dataset=ds, strategy=s, dim=d, impl=i, scale=scale)
        for ds in datasets
        for s in (g["strategy"][:2] if quick else g["strategy"])
        for d in (g["dim"][:1] if quick else g["dim"])
        for i in (g["impl"][:2] if quick else g["impl"])
    ]
    return _run_grid(cases, functools.partial(harness.bench_graph,
                                              device=device), out)


def sweep_scaling(devices=None, out=None, device=None):
    """bench_scaling at its defaults over worlds of `devices` ranks
    (default 1, 2, 4: the JAX sweep's device counts up to the four ranks a
    card's runs use)."""
    rec = harness.bench_scaling(devices or [1, 2, 4], device=device)
    _emit(rec, out)
    return [rec]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="spmm_denseblock_tpu_torch.bench")
    ap.add_argument("sweep", choices=["bsrmm", "csrmm", "graph", "scaling"])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--datasets", nargs="*", default=None)
    ap.add_argument("--devices", nargs="*", type=int, default=None)
    ap.add_argument("--scale", type=float, default=None)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the plans run (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)  # raises where there is no GPU
    out = open(args.out, "w") if args.out else None
    try:
        if args.sweep == "bsrmm":
            sweep_bsrmm(quick=args.quick, out=out, device=device)
        elif args.sweep == "csrmm":
            sweep_csrmm(quick=args.quick, out=out, device=device)
        elif args.sweep == "graph":
            sweep_graph(datasets=args.datasets, quick=args.quick, out=out,
                        scale=args.scale, device=device)
        else:
            sweep_scaling(devices=args.devices, out=out, device=device)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
