#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spmm_denseblock_tpu_torch) on one NVIDIA
GPU: builds the CUDA kernels from this checkout, holds each against its
plain PyTorch version, serves a GCN on the ogbl-ddi stand-in through the
BSR SpMM plan, and runs the plan at bench.py's op shape.

    python3 chip_smoke.py

Phases:
  1. set-up   torch/CUDA versions, the card's name and power limit, TF32 off
  2. build    nvcc builds csrc/bsr_spmm.cu into build/kernels/ (timed)
  3. kernels  K1 (flat) and K2 (sorted), f32 and bf16, at a small shape
              and at the ddi shape, each against its plain version
  4. slice    GCN [256, 256, 256] on load_dataset("ogbl-ddi") (rcmk,
              sym_norm_adjacency, spmm_plan(impl="bsr_pallas", b=128)),
              4 seeded requests, each checked against a float64 host
              reference at 1e-4
  5. op       random_bsr(2e-2, 1024, 1024, b=128, seed=1234), F=512: the
              default plan (K2) and depth_sort=False (K1), f32 and bf16,
              each against its plain version
  6. timing   CUDA-event times of kernel and plain paths, GFLOP/s =
              2*nnzb*b^2*F / t

Launch counts are reset before phase 4 and read after phase 5: those are
the main path's launches, and each kernel must have run there. Prints
the kernels' JSON line, then the last line
{"ok": true, "device": {...}}. Any failure raises and exits non-zero;
there is no CPU path.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from spmm_denseblock_tpu_torch.formats.bsr import BSR, random_bsr  # noqa: E402
from spmm_denseblock_tpu_torch.io.datasets import load_dataset  # noqa: E402
from spmm_denseblock_tpu_torch.models import GCN, sym_norm_adjacency  # noqa: E402
from spmm_denseblock_tpu_torch.ops import _kernels, spmm_plan  # noqa: E402
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import (  # noqa: E402
    bsr_spmm_pallas_plan,
    plain_apply,
)
from spmm_denseblock_tpu_torch.ops.reference import CHECK_EPS, assert_allclose  # noqa: E402
from spmm_denseblock_tpu_torch.reorder import reorder  # noqa: E402

KERNEL_TOL = 1e-5  # kernel vs plain version, relative to max |plain|
SEED = 1234
DEV = "cuda"
# plan layout -> (id, kernel, the pallas_call of the TPU kernel it replaces)
KERNEL_INFO = {
    "flat": ("K1", "bsr_spmm_flat",
             "spmm_denseblock_tpu/ops/bsr_spmm_pallas.py:909"),
    "sorted": ("K2", "bsr_spmm_sorted",
               "spmm_denseblock_tpu/ops/bsr_spmm_pallas.py:686"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call between CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def launches() -> dict:
    return {k.symbol.replace("sdb_", ""): k.launches for k in _kernels.KERNELS}


def check_kernel(plan, x, label: str) -> float:
    """Kernel path vs plain path of one plan on the same device operand;
    returns max |kernel - plain|. Raises past KERNEL_TOL."""
    name = KERNEL_INFO[plan.statics[0]][1]
    before = launches()[name]
    got = plan(x)
    torch.cuda.synchronize()
    if launches()[name] != before + 1:
        raise AssertionError(f"{label}: {name} did not launch")
    want = plain_apply(plan, x)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad output {tuple(got.shape)}")
    err = (got - want).abs().max().item()
    rel = err / max(want.abs().max().item(), 1.0)
    log(f"  {label:<34} {name:<16} max_abs_err={err:.3e} rel={rel:.3e}")
    if rel >= KERNEL_TOL:
        raise AssertionError(f"{label}: rel err {rel:.3e} >= {KERNEL_TOL}")
    return err


def seeded(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def ddi_adjacency(cache_dir: Path):
    csr = load_dataset("ogbl-ddi", cache_dir=str(cache_dir), seed=SEED)
    rcsr, _ = reorder(csr, "rcmk")
    return sym_norm_adjacency(rcsr)


def ddi_nnzb(adj, b: int) -> int:
    """Real (nonzero) b x b blocks of a CSR matrix."""
    rows = adj.row_ids().astype(np.int64) // b
    cols = np.asarray(adj.indices, dtype=np.int64) // b
    return int(np.unique(rows * (-(-adj.n_cols // b)) + cols).size)


def kernel_phase(adj) -> None:
    log("[kernels] K1 and K2 against their plain versions "
        f"(tolerance rel {KERNEL_TOL})")
    small = random_bsr(0.35, 37, 29, block_size=64, seed=3)
    small = BSR.from_parts(small.block_rows, small.block_cols, small.blocks,
                           (37 * 64 - 9, 29 * 64 - 5), 64)
    x_small = torch.as_tensor(seeded((small.shape[1], 200), 4), device=DEV)
    x_ddi = torch.as_tensor(seeded((adj.n_cols, 256), 5), device=DEV)
    for dtype in (None, torch.bfloat16):
        tag = "f32" if dtype is None else "bf16"
        for depth_sort in (True, False):
            p = bsr_spmm_pallas_plan(small, dtype=dtype, grad=False,
                                     depth_sort=depth_sort, device=DEV)
            check_kernel(p, x_small, f"small b=64 {tag} {p.statics[0]}")
            p = spmm_plan(adj, impl="bsr_pallas", block_size=128, grad=False,
                          dtype=dtype, depth_sort=depth_sort, device=DEV)
            check_kernel(p, x_ddi, f"ddi b=128 F=256 {tag} {p.statics[0]}")


def slice_phase(adj, dims, n_requests: int):
    """GCN serving on the ddi stand-in; returns (plan, model, features)."""
    log(f"[slice] GCN {dims} on ogbl-ddi stand-in: n={adj.n_rows} "
        f"nnz={adj.nnz}, {n_requests} requests")
    plan = spmm_plan(adj, impl="bsr_pallas", block_size=128, grad=False,
                     device=DEV)
    if plan.statics[0] != "sorted":
        raise AssertionError(f"ddi plan took {plan.statics[0]}, expected sorted (K2)")
    gen = torch.Generator().manual_seed(SEED)
    model = GCN(dims, generator=gen).to(DEV)
    params = [{k: v.detach().cpu().double().numpy() for k, v in p.items()}
              for p in model.params()]
    a64 = adj.to_scipy().astype(np.float64)
    xs = []
    for r in range(n_requests):
        x = seeded((adj.n_rows, dims[0]), SEED + 100 + r)
        with torch.no_grad():
            out = model(plan, torch.as_tensor(x, device=DEV))
        torch.cuda.synchronize()
        h = x.astype(np.float64)
        for i, p in enumerate(params):
            h = a64 @ h @ p["w"] + p["b"]
            if i < len(params) - 1:
                h = np.maximum(h, 0.0)
        if out.shape != h.shape or not torch.isfinite(out).all():
            raise AssertionError(f"request {r}: bad output {tuple(out.shape)}")
        assert_allclose(out, h, eps=CHECK_EPS, msg=f"request {r}")
        err = np.abs(out.cpu().double().numpy() - h).max()
        log(f"  request {r}: out {tuple(out.shape)} finite, max_abs_err vs "
            f"f64 reference {err:.3e} (< {CHECK_EPS} gate)")
        xs.append(torch.as_tensor(x, device=DEV))
    return plan, model, xs


def op_plans(bsr):
    """The default plan (K2 at this occupancy) and depth_sort=False (K1),
    f32 and bf16."""
    plans = {}
    for dtype in (None, torch.bfloat16):
        tag = "f32" if dtype is None else "bf16"
        for depth_sort, layout in ((None, "sorted"), (False, "flat")):
            p = bsr_spmm_pallas_plan(bsr, dtype=dtype, grad=False,
                                     depth_sort=depth_sort, device=DEV)
            if p.statics[0] != layout:
                raise AssertionError(f"op {tag} depth_sort={depth_sort} took "
                                     f"{p.statics[0]}, expected {layout}")
            plans[(tag, layout)] = p
    return plans


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = card()
    kind = torch.cuda.get_device_name(0)
    log(f"[setup] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind}")
    log(f"[setup] nvidia-smi: {card_line}")

    t0 = time.perf_counter()
    lib = _kernels.build()
    _kernels.load()
    log(f"[build] {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    adj = ddi_adjacency(ROOT / "build" / "datasets")
    log(f"[setup] ddi adjacency in {time.perf_counter() - t0:.1f} s")
    kernel_phase(adj)

    # ---- main path: counts from here to the end of the op phase --------
    for k in _kernels.KERNELS:
        k.launches = 0
    dims = [256, 256, 256]
    plan, model, xs = slice_phase(adj, dims, n_requests=4)
    slice_launches = launches()
    if slice_launches["bsr_spmm_sorted"] != 4 * (len(dims) - 1):
        raise AssertionError(f"slice launches {slice_launches}")

    t0 = time.perf_counter()
    op_bsr = random_bsr(2e-2, 1024, 1024, block_size=128, seed=SEED)
    F = 512
    x_op = torch.as_tensor(seeded((op_bsr.shape[1], F), SEED), device=DEV)
    plans = op_plans(op_bsr)
    log(f"[op] random_bsr(2e-2, 1024, b=128): nnzb={op_bsr.nnzb}, F={F}, "
        f"plans built in {time.perf_counter() - t0:.1f} s")
    errs = {}
    for (tag, layout), p in plans.items():
        err = check_kernel(p, x_op, f"op {tag} {layout}")
        if tag == "f32":
            errs[layout] = err
    main_launches = launches()
    log(f"[main path] launches {main_launches}")
    for name, n in main_launches.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the main path")

    # ---- timing (after the counts were read) ----------------------------
    log(f"[timing] card: {card_line}")
    x0 = xs[0]
    with torch.no_grad():
        gcn_ms = cuda_ms(lambda: model(plan, x0), iters=20)
        gcn_plain_ms = cuda_ms(
            lambda: model(lambda h: plain_apply(plan, h), x0), iters=20)
        spmm_ms = cuda_ms(lambda: plan(x0), iters=20)
        spmm_plain_ms = cuda_ms(lambda: plain_apply(plan, x0), iters=20)
    log(f"  slice GCN request (X on device): kernel {gcn_ms:.3f} ms, "
        f"plain {gcn_plain_ms:.3f} ms [{card_line}]")
    ddi_flops = 2.0 * ddi_nnzb(adj, 128) * 128 * 128 * dims[0]
    log(f"  slice A @ H, F={dims[0]} f32: kernel {spmm_ms:.3f} ms "
        f"{ddi_flops / spmm_ms / 1e6:.1f} GFLOP/s, plain {spmm_plain_ms:.3f} ms "
        f"{ddi_flops / spmm_plain_ms / 1e6:.1f} GFLOP/s [{card_line}]")
    flops = 2.0 * op_bsr.nnzb * 128 * 128 * F
    times = {}
    for (tag, layout), p in plans.items():
        k_ms = cuda_ms(lambda: p(x_op), iters=10)
        p_ms = cuda_ms(lambda: plain_apply(p, x_op), iters=5, warmup=1)
        times[(tag, layout)] = (k_ms, p_ms)
        log(f"  op {tag} {layout:<6} kernel {k_ms:.3f} ms "
            f"{flops / k_ms / 1e6:.1f} GFLOP/s, plain {p_ms:.3f} ms "
            f"{flops / p_ms / 1e6:.1f} GFLOP/s [{card_line}]")

    kernels = []
    for layout, (kid, name, replaces) in KERNEL_INFO.items():
        k_ms, p_ms = times[("f32", layout)]
        kernels.append({
            "name": f"{kid} {name}",
            "route": "cuda",
            "source": "spmm_denseblock_tpu_torch/csrc/bsr_spmm.cu",
            "replaces": replaces,
            "launches": main_launches[name],
            "max_abs_err": errs[layout],
            "ms": k_ms,
            "plain_ms": p_ms,
        })
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
