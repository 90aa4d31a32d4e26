"""Serving example: reorder once, quantize once, stream SpMM inference
(twin of ``examples/serve_spmm.py``).

    python -m spmm_denseblock_tpu_torch.examples.serve_spmm [--dataset ogbn-arxiv]
        [--scale 0.1] [--impl bsr_int8_pallas] [--dim 256] [--check] [--device cpu]

The deployment path: offline preprocessing (reorder, format conversion,
int8 quantization) and then a hot loop of C = A @ X calls on fresh
feature batches, the production shape of the reference's run_csrmm /
run_bsrmm measurement loop.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from spmm_denseblock_tpu_torch.analyze.metrics import block_metrics
from spmm_denseblock_tpu_torch.bench.timing import time_synced
from spmm_denseblock_tpu_torch.io.datasets import load_dataset
from spmm_denseblock_tpu_torch.ops import spmm_plan, spmm_scipy
from spmm_denseblock_tpu_torch.ops._device import resolve_device
from spmm_denseblock_tpu_torch.reorder import reorder_cached


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="ogbn-arxiv")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--strategy", default="rabbit")
    ap.add_argument(
        "--impl", default="auto",
        help="auto prices its candidates by what the plan runs: real "
        "(element-sparse) graphs go to csr_ell on the card in f32 (the ELL "
        "kernel), mostly to hybrid elsewhere; "
        "bsr_int8_pallas is the quantized block tier for block-dense inputs; "
        "csr_ell_int8 / hybrid_int8 are the quantized serving tiers for "
        "gather-bound graphs (use with --calibrate)")
    ap.add_argument("--block-size", type=int, default=128)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--check", action="store_true", help="verify vs scipy")
    ap.add_argument(
        "--calibrate", action="store_true",
        help="int8 tiers: fix per-column operand scales from one "
        "representative batch at plan time (static-scale serving: no "
        "per-call absmax reduction)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the plan runs (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.perf_counter()
    csr = load_dataset(args.dataset, scale=args.scale)
    rcsr, _ = reorder_cached(csr, args.strategy, tag=f"{args.dataset}_s{args.scale}")
    m = block_metrics(rcsr, [args.block_size])[args.block_size]
    plan_kw = {}
    if args.calibrate and "int8" in args.impl:
        plan_kw["calibration"] = np.random.default_rng(1).standard_normal(
            (rcsr.n_cols, args.dim)).astype(np.float32)
    plan = spmm_plan(rcsr, impl=args.impl, block_size=args.block_size,
                     grad=False, device=dev, **plan_kw)
    print(f"offline prep {time.perf_counter() - t0:.1f}s: n={csr.n_rows} "
          f"nnz={csr.nnz} density={m['density']:.5f}")

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((rcsr.n_cols, args.dim)).astype(np.float32),
                        device=dev)
    with torch.no_grad():
        if args.check:
            got = plan(x).float().cpu().numpy()
            want = spmm_scipy(rcsr, x.cpu().numpy())
            rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
            print(f"check vs scipy: rel err {rel:.2e}")
        secs = time_synced(plan, x, iters=10)
    print(f"{args.impl}: {secs * 1e3:.2f} ms/call  "
          f"{csr.nnz / secs / 1e9:.2f} Gnnz/s  "
          f"{2 * csr.nnz * args.dim / secs / 1e9:.0f} GFLOP/s")


if __name__ == "__main__":
    main()
