#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spmm_denseblock_tpu_torch) on one NVIDIA
GPU: builds the CUDA kernels from this checkout, holds each against its
plain PyTorch version, serves a GCN on the ogbl-ddi stand-in through the
BSR SpMM plan in f32 and in int8, and runs the plans at bench.py's op
shape.

    python3 chip_smoke.py

Phases:
  1. set-up   torch/CUDA versions, the card's name and power limit, TF32 off
  2. build    nvcc builds each csrc/*.cu into build/kernels/, all at once
              (timed)
  3. kernels  K1 (flat), K2 (sorted), K4 (row groups; f32 and bf16), and
              the int8 K6 (flat), K7 (sorted; group-scale and per-slot
              scales) and K8 (row groups), each against its plain version
              at a ragged small shape, a 7-block-row shape (phantom and
              absent lanes) and the ddi shape
  4. slice    GCN [256, 256, 256] on load_dataset("ogbl-ddi") (rcmk,
              sym_norm_adjacency, spmm_plan(impl="bsr_pallas", b=128)),
              4 seeded requests in f32 (K2), each checked against a float64
              host reference at 1e-4; then the same requests through
              spmm_plan(..., dtype=torch.int8) (bsr_int8_pallas, K7), each
              answer within 6e-2 of the float64 reference and each SpMM
              within 1e-5 of its plain version
  5. op       random_bsr(2e-2, 1024, 1024, b=128, seed=1234), F=512: f32
              default (K2) and depth_sort=False (K1); bf16 default (K2),
              depth_sort=False (K4) and resident=False (K1); int8 with
              calibration=dense[:4096] as bench.py: default (K7),
              depth_sort=False (K8) and resident=False (K6); each against
              its plain version, each int8 answer within 6e-2 of f32 K2's
  6. timing   CUDA-event times of kernel and plain paths, GFLOP/s =
              2*nnzb*b^2*F / t (real blocks); the int8 operand's
              quantization (dynamic and static) apart from its kernel

The main path is phases 4 and 5, each of their three runs (f32 slice,
int8 slice, op) with the launch counts set to 0 just before it and read
just after; every kernel of the path must have run there. Prints the
kernels' JSON line, then the last line {"ok": true, "device": {...}}.
Any failure raises and exits non-zero; there is no CPU path.
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

from spmm_denseblock_tpu_torch.convert.csr2bsr import csr_to_bsr  # noqa: E402
from spmm_denseblock_tpu_torch.formats.bsr import BSR, random_bsr  # noqa: E402
from spmm_denseblock_tpu_torch.io.datasets import load_dataset  # noqa: E402
from spmm_denseblock_tpu_torch.models import GCN, sym_norm_adjacency  # noqa: E402
from spmm_denseblock_tpu_torch.ops import _kernels, spmm_plan  # noqa: E402
from spmm_denseblock_tpu_torch.ops.bsr_spmm_int8 import quantize_per_column  # noqa: E402
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import (  # noqa: E402
    _auto_group_pow2,
    _ensure_covering,
    _pack_rowgroups,
    _pallas_apply,
    _rowgroup_policy,
    bsr_spmm_pallas_plan,
    group_pointer,
    plain_apply,
)
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas_int8 import (  # noqa: E402
    _int8_pallas_apply,
    bsr_spmm_pallas_int8_plan,
    quantize_operand,
    run_quantized,
)
from spmm_denseblock_tpu_torch.ops.plan import Plan  # noqa: E402
from spmm_denseblock_tpu_torch.ops.reference import CHECK_EPS, assert_allclose  # noqa: E402
from spmm_denseblock_tpu_torch.reorder import reorder  # noqa: E402

KERNEL_TOL = 1e-5  # kernel vs plain version, relative to max |plain|
INT8_TOL = 6e-2    # int8 answer vs f32/f64 reference, relative to max |ref|
SEED = 1234
DEV = "cuda"
_PALLAS = "spmm_denseblock_tpu/ops/bsr_spmm_pallas.py"
_PALLAS_I8 = "spmm_denseblock_tpu/ops/bsr_spmm_pallas_int8.py"
_CSRC = "spmm_denseblock_tpu_torch/csrc/"
# (plan family, layout) -> (id, kernel, source, the pallas_call it replaces)
KERNEL_INFO = {
    ("f", "flat"): ("K1", "bsr_spmm_flat", _CSRC + "bsr_spmm.cu", _PALLAS + ":909"),
    ("f", "sorted"): ("K2", "bsr_spmm_sorted", _CSRC + "bsr_spmm.cu", _PALLAS + ":686"),
    ("f", "rowgroup"): ("K4", "bsr_spmm_rowgroup", _CSRC + "bsr_spmm.cu",
                        _PALLAS + ":412"),
    ("i8", "flat"): ("K6", "bsr_spmm_int8_flat", _CSRC + "bsr_spmm_int8.cu",
                     _PALLAS_I8 + ":490"),
    ("i8", "sorted"): ("K7", "bsr_spmm_int8_sorted", _CSRC + "bsr_spmm_int8.cu",
                       _PALLAS_I8 + ":358"),
    ("i8", "rowgroup"): ("K8", "bsr_spmm_int8_rowgroup", _CSRC + "bsr_spmm_int8.cu",
                         _PALLAS_I8 + ":252"),
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


def reset_launches() -> None:
    for k in _kernels.KERNELS:
        k.launches = 0


def kernel_of(plan) -> tuple:
    """(id, kernel, source, replaces) of the kernel a plan launches."""
    family = "i8" if plan.apply_fn is _int8_pallas_apply else "f"
    return KERNEL_INFO[(family, plan.statics[0])]


def rel_err(got, want) -> float:
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)


def check_kernel(plan, x, label: str) -> float:
    """Kernel path vs plain path of one plan on the same device operand;
    returns max |kernel - plain|. Raises past KERNEL_TOL."""
    kid, name = kernel_of(plan)[:2]
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
    rel = rel_err(got, want)
    log(f"  {label:<40} {kid} {name:<22} max_abs_err={err:.3e} rel={rel:.3e}")
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


def f32_rowgroup_plan(bsr: BSR) -> Plan:
    """K4 with f32 operands. The plan routes only bf16 to the row-group
    layout, so this packs it as the bf16 plan does (R=16, the pow2 group
    capped at 16) and keeps the blocks in f32."""
    cov = _ensure_covering(bsr)
    rows = cov.block_rows[: cov.nnzb]
    gh = min(_auto_group_pow2(cov.nnzb, np.unique(rows).size), 16)
    R, _ = _rowgroup_policy(2, gh)
    step_groups, slot_cols, blocks, n_groups = _pack_rowgroups(
        rows, cov.block_cols[: cov.nnzb], cov.blocks[: cov.nnzb], gh, R)
    statics = ("rowgroup", cov.n_block_rows, *bsr.shape,
               cov.n_block_cols * bsr.b, (R, gh))
    return Plan([step_groups, slot_cols, blocks,
                 group_pointer(step_groups, n_groups)],
                _pallas_apply, statics, device=DEV)


def variant_plans(bsr: BSR):
    """(label, plan) for every kernel and operand type of the port."""
    bf = torch.bfloat16
    f_plan = lambda **kw: bsr_spmm_pallas_plan(bsr, grad=False, device=DEV, **kw)
    i8_plan = lambda **kw: bsr_spmm_pallas_int8_plan(bsr, device=DEV, **kw)
    return [
        ("f32 depth_sort", f_plan(depth_sort=True)),
        ("f32 depth_sort=False", f_plan(depth_sort=False)),
        ("f32 row groups", f32_rowgroup_plan(bsr)),
        ("bf16 depth_sort", f_plan(dtype=bf, depth_sort=True)),
        ("bf16 depth_sort=False", f_plan(dtype=bf, depth_sort=False)),
        ("bf16 resident=False", f_plan(dtype=bf, resident=False)),
        ("int8 depth_sort", i8_plan(depth_sort=True)),
        ("int8 per-slot scales", i8_plan(depth_sort=True, group_scale=False)),
        ("int8 depth_sort=False", i8_plan(depth_sort=False)),
        ("int8 resident=False", i8_plan(resident=False)),
    ]


def kernel_phase(adj) -> None:
    log("[kernels] every kernel against its plain version "
        f"(tolerance rel {KERNEL_TOL})")
    small = random_bsr(0.35, 37, 29, block_size=64, seed=3)
    small = BSR.from_parts(small.block_rows, small.block_cols, small.blocks,
                           (37 * 64 - 9, 29 * 64 - 5), 64)
    phantom = random_bsr(0.3, 7, 7, block_size=32, seed=9)
    shapes = (
        ("small b=64 F=200", small, 200, 4),
        ("7 block-rows b=32 F=96", phantom, 96, 6),
        ("ddi b=128 F=256", csr_to_bsr(adj, 128), 256, 5),
    )
    for tag, bsr, F, seed in shapes:
        x = torch.as_tensor(seeded((bsr.shape[1], F), seed), device=DEV)
        checked = set()
        for label, p in variant_plans(bsr):
            check_kernel(p, x, f"{tag} {label}")
            checked.add(kernel_of(p)[0])
        if checked != {"K1", "K2", "K4", "K6", "K7", "K8"}:
            raise AssertionError(f"{tag}: kernels checked {sorted(checked)}")


def gcn_reference(adj, params, x) -> np.ndarray:
    h = x.astype(np.float64)
    a64 = adj.to_scipy().astype(np.float64)
    for i, p in enumerate(params):
        h = a64 @ h @ p["w"] + p["b"]
        if i < len(params) - 1:
            h = np.maximum(h, 0.0)
    return h


def slice_phase(adj, dims, n_requests: int):
    """f32 GCN serving on the ddi stand-in; returns (plan, model, xs,
    refs)."""
    log(f"[slice] GCN {dims} on ogbl-ddi stand-in: n={adj.n_rows} "
        f"nnz={adj.nnz}, {n_requests} requests, f32")
    plan = spmm_plan(adj, impl="bsr_pallas", block_size=128, grad=False,
                     device=DEV)
    if kernel_of(plan)[0] != "K2":
        raise AssertionError(f"ddi plan took {plan.statics[0]}, expected sorted (K2)")
    gen = torch.Generator().manual_seed(SEED)
    model = GCN(dims, generator=gen).to(DEV)
    params = [{k: v.detach().cpu().double().numpy() for k, v in p.items()}
              for p in model.params()]
    xs, refs = [], []
    for r in range(n_requests):
        x = seeded((adj.n_rows, dims[0]), SEED + 100 + r)
        with torch.no_grad():
            out = model(plan, torch.as_tensor(x, device=DEV))
        torch.cuda.synchronize()
        h = gcn_reference(adj, params, x)
        if out.shape != h.shape or not torch.isfinite(out).all():
            raise AssertionError(f"request {r}: bad output {tuple(out.shape)}")
        assert_allclose(out, h, eps=CHECK_EPS, msg=f"request {r}")
        err = np.abs(out.cpu().double().numpy() - h).max()
        log(f"  request {r}: out {tuple(out.shape)} finite, max_abs_err vs "
            f"f64 reference {err:.3e} (< {CHECK_EPS} gate)")
        xs.append(torch.as_tensor(x, device=DEV))
        refs.append(h)
    return plan, model, xs, refs


def int8_slice_phase(adj, model, xs, refs):
    """int8 GCN serving on the ddi stand-in through spmm_plan(dtype=int8);
    returns the plan and the largest SpMM max |kernel - plain|."""
    log(f"[slice] the same {len(xs)} requests, int8 "
        "(spmm_plan(impl='bsr_pallas', dtype=torch.int8))")
    plan = spmm_plan(adj, impl="bsr_pallas", block_size=128, grad=False,
                     dtype=torch.int8, device=DEV)
    if kernel_of(plan)[0] != "K7" or not plan.statics[5][3]:
        raise AssertionError(f"ddi int8 plan took {plan.statics}, expected "
                             "sorted group-scale (K7)")
    spmm_errs = []

    def checked_spmm(h):
        got = plan(h)
        want = plain_apply(plan, h)
        rel = rel_err(got, want)
        if not torch.isfinite(got).all() or rel >= KERNEL_TOL:
            raise AssertionError(f"int8 SpMM vs plain: rel {rel:.3e}")
        spmm_errs.append((got - want).abs().max().item())
        return got

    for r, (x, h) in enumerate(zip(xs, refs)):
        with torch.no_grad():
            out = model(checked_spmm, x)
        torch.cuda.synchronize()
        if out.shape != h.shape or not torch.isfinite(out).all():
            raise AssertionError(f"int8 request {r}: bad output {tuple(out.shape)}")
        rel = np.abs(out.cpu().double().numpy() - h).max() / np.abs(h).max()
        log(f"  int8 request {r}: rel err vs f64 reference {rel:.3e} "
            f"(< {INT8_TOL} gate); its 2 SpMMs within "
            f"{max(spmm_errs[-2:]):.3e} of the plain version")
        if rel >= INT8_TOL:
            raise AssertionError(f"int8 request {r}: rel err {rel:.3e}")
    return plan, max(spmm_errs)


def op_plans(bsr, calibration):
    """bench.py's op shape: f32 and bf16 and int8, each layout."""
    bf = torch.bfloat16
    specs = (
        ("f32", "sorted", lambda: bsr_spmm_pallas_plan(bsr, grad=False, device=DEV)),
        ("f32", "flat", lambda: bsr_spmm_pallas_plan(
            bsr, grad=False, depth_sort=False, device=DEV)),
        ("bf16", "sorted", lambda: bsr_spmm_pallas_plan(
            bsr, dtype=bf, grad=False, device=DEV)),
        ("bf16", "rowgroup", lambda: bsr_spmm_pallas_plan(
            bsr, dtype=bf, grad=False, depth_sort=False, device=DEV)),
        ("bf16", "flat", lambda: bsr_spmm_pallas_plan(
            bsr, dtype=bf, grad=False, resident=False, device=DEV)),
        ("int8", "sorted", lambda: bsr_spmm_pallas_int8_plan(
            bsr, calibration=calibration, device=DEV)),
        ("int8", "rowgroup", lambda: bsr_spmm_pallas_int8_plan(
            bsr, calibration=calibration, depth_sort=False, device=DEV)),
        ("int8", "flat", lambda: bsr_spmm_pallas_int8_plan(
            bsr, calibration=calibration, resident=False, device=DEV)),
    )
    plans = {}
    for tag, layout, build in specs:
        p = build()
        if p.statics[0] != layout:
            raise AssertionError(f"op {tag} took {p.statics[0]}, expected {layout}")
        plans[(tag, layout)] = p
    return plans


def main_path(adj, dims, op_bsr, x_op, calibration):
    """Phases 4 and 5, each run with the launch counts set to 0 just
    before it and read just after. Returns what the timing needs."""
    totals = {}

    def read(run: str, expect: dict) -> None:
        counts = launches()
        log(f"[main path] {run}: launches {counts}")
        for name, n in expect.items():
            if counts[name] != n:
                raise AssertionError(f"{run}: {name} launched {counts[name]} "
                                     f"times, expected {n}")
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n

    n_spmm = 4 * (len(dims) - 1)
    reset_launches()
    plan, model, xs, refs = slice_phase(adj, dims, n_requests=4)
    read("f32 slice", {"bsr_spmm_sorted": n_spmm})
    reset_launches()
    plan_i8, slice_i8_err = int8_slice_phase(adj, model, xs, refs)
    read("int8 slice", {"bsr_spmm_int8_sorted": n_spmm})

    reset_launches()
    t0 = time.perf_counter()
    plans = op_plans(op_bsr, calibration)
    log(f"[op] random_bsr(2e-2, 1024, b=128): nnzb={op_bsr.nnzb}, "
        f"F={x_op.shape[1]}, {len(plans)} plans built in "
        f"{time.perf_counter() - t0:.1f} s")
    errs, outs = {}, {}
    for (tag, layout), p in plans.items():
        errs[(tag, layout)] = check_kernel(p, x_op, f"op {tag} {layout}")
        if tag != "bf16":
            outs[(tag, layout)] = p(x_op)
    read("op", {})
    ref = outs[("f32", "sorted")]
    for (tag, layout), out in outs.items():
        if tag == "int8":
            rel = (out - ref).abs().max().item() / ref.abs().max().item()
            log(f"  op int8 {layout:<8} vs f32 K2: rel err {rel:.3e} (< {INT8_TOL})")
            if rel >= INT8_TOL:
                raise AssertionError(f"op int8 {layout}: rel err {rel:.3e}")
    del outs, ref
    for name, n in totals.items():
        if n == 0:
            raise AssertionError(f"{name} was not launched on the main path")
    return plan, plan_i8, model, xs, plans, errs, totals, slice_i8_err


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
    libs = _kernels.build()
    _kernels.load()
    log(f"[build] {', '.join(str(p.relative_to(ROOT)) for p in libs)} in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    adj = ddi_adjacency(ROOT / "build" / "datasets")
    log(f"[setup] ddi adjacency in {time.perf_counter() - t0:.1f} s")
    kernel_phase(adj)

    op_bsr = random_bsr(2e-2, 1024, 1024, block_size=128, seed=SEED)
    F = 512
    dense = seeded((op_bsr.shape[1], F), SEED)
    x_op = torch.as_tensor(dense, device=DEV)
    dims = [256, 256, 256]
    (plan, plan_i8, model, xs, plans, errs, main_launches,
     slice_i8_err) = main_path(adj, dims, op_bsr, x_op, dense[:4096])

    # ---- timing (after the counts were read) ----------------------------
    log(f"[timing] card: {card_line}")
    x0 = xs[0]
    ddi_flops = 2.0 * ddi_nnzb(adj, 128) * 128 * 128 * dims[0]
    with torch.no_grad():
        for tag, p in (("f32", plan), ("int8", plan_i8)):
            gcn_ms = cuda_ms(lambda: model(p, x0), iters=20)
            gcn_plain_ms = cuda_ms(
                lambda: model(lambda h: plain_apply(p, h), x0), iters=20)
            spmm_ms = cuda_ms(lambda: p(x0), iters=20)
            spmm_plain_ms = cuda_ms(lambda: plain_apply(p, x0), iters=20)
            log(f"  slice GCN request {tag} (X on device): kernel {gcn_ms:.3f} ms, "
                f"plain {gcn_plain_ms:.3f} ms [{card_line}]")
            log(f"  slice A @ H, F={dims[0]} {tag} {kernel_of(p)[0]}: kernel "
                f"{spmm_ms:.3f} ms {ddi_flops / spmm_ms / 1e6:.1f} GFLOP/s, plain "
                f"{spmm_plain_ms:.3f} ms {ddi_flops / spmm_plain_ms / 1e6:.1f} "
                f"GFLOP/s [{card_line}]")
    flops = 2.0 * op_bsr.nnzb * 128 * 128 * F
    times = {}
    for (tag, layout), p in plans.items():
        kid = kernel_of(p)[0]
        if tag == "int8":
            q, cs = quantize_operand(p, x_op)
            k_ms = cuda_ms(lambda: run_quantized(p, q, cs), iters=10)
            p_ms = cuda_ms(lambda: run_quantized(p, q, cs, plain=True),
                           iters=5, warmup=1)
            whole_ms = cuda_ms(lambda: p(x_op), iters=10)
            extra = f", whole call with static quantization {whole_ms:.3f} ms"
        else:
            k_ms = cuda_ms(lambda: p(x_op), iters=10)
            p_ms = cuda_ms(lambda: plain_apply(p, x_op), iters=5, warmup=1)
            extra = ""
        times[kid] = times.get(kid, (k_ms, p_ms))
        log(f"  op {tag:<4} {layout:<8} {kid} kernel {k_ms:.3f} ms "
            f"{flops / k_ms / 1e6:.1f} GFLOP/s, plain {p_ms:.3f} ms "
            f"{flops / p_ms / 1e6:.1f} GFLOP/s{extra} [{card_line}]")
    cs_static = plans[("int8", "sorted")].arrays[-1]
    q_dyn_ms = cuda_ms(lambda: quantize_per_column(x_op), iters=10)
    q_static_ms = cuda_ms(lambda: quantize_per_column(x_op, cs_static), iters=10)
    log(f"  op int8 operand quantization ({x_op.shape[0]} x {F} f32): dynamic "
        f"{q_dyn_ms:.3f} ms, static {q_static_ms:.3f} ms [{card_line}]")

    # each kernel's entry: the op-shape plan that runs it first above
    # (K1 f32 flat, K2 f32 sorted, K4 bf16, K6-K8 int8, kernel only)
    kernels = []
    for (tag, layout), p in plans.items():
        kid, name, source, replaces = kernel_of(p)
        if any(k["name"].startswith(kid + " ") for k in kernels):
            continue
        k_ms, p_ms = times[kid]
        kernels.append({
            "name": f"{kid} {name}",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": main_launches[name],
            "max_abs_err": errs[(tag, layout)],
            "ms": k_ms,
            "plain_ms": p_ms,
        })
    kernels.sort(key=lambda k: int(k["name"].split()[0][1:]))
    log(f"[slice] int8 SpMMs' largest max |kernel - plain|: {slice_i8_err:.3e}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
