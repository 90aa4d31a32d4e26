"""Benchmark case runners (twin of ``spmm_denseblock_tpu/bench/harness.py``;
the reference's test_csrmm, test_bsrmm, run_csrmm, run_bsrmm and divide
drivers as a library).

Every runner returns a flat, JSON-serializable record with JAX's keys:
ms and its spread over repeats, GFLOP/s by the reference's formulas
(2 * nnzb * b^2 * F for BSR, 2 * nnz * F for CSR), block density and
utilization, bytes moved and arithmetic intensity. The port adds
"device": the card's name, or "cpu". Times are CUDA-event times on the
card (bench/timing); a runner given no device runs there, and raises
where there is no GPU.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from spmm_denseblock_tpu_torch.analyze.metrics import block_metrics
from spmm_denseblock_tpu_torch.bench.timing import (
    cuda_ms,
    time_chained,
    time_chained_square,
    time_repeats,
)
from spmm_denseblock_tpu_torch.convert.csr2bsr import csr_to_bsr
from spmm_denseblock_tpu_torch.convert.divide import divide
from spmm_denseblock_tpu_torch.formats.bsr import BSR, random_bsr
from spmm_denseblock_tpu_torch.formats.csr import random_csr
from spmm_denseblock_tpu_torch.io.datasets import (
    dataset_provenance,
    graph_stats,
    load_dataset,
)
from spmm_denseblock_tpu_torch.ops import spmm_plan
from spmm_denseblock_tpu_torch.ops._device import resolve_device
from spmm_denseblock_tpu_torch.ops.bsr_spmm_int8 import dtype_name
from spmm_denseblock_tpu_torch.ops.plan import transb_plan
from spmm_denseblock_tpu_torch.reorder import reorder

def _dense_operand(n_rows: int, dim: int, seed: int = 1234) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_rows, dim)).astype(np.float32)


def _torch_dtype(dtype) -> Optional[torch.dtype]:
    """A torch dtype for a torch dtype or its name; None stays None."""
    return None if dtype is None else getattr(torch, dtype_name(dtype))


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time(plan, x) -> float:
    """Seconds per call of plan on x (a tensor on the plan's device)."""
    with torch.no_grad():
        probe = plan(x)
        if probe.shape == x.shape:
            return time_chained_square(plan, x)
        return time_chained(plan, x)


def _time_spread(plan, x, repeats: int = 3) -> dict:
    """time_repeats on x (a tensor on the plan's device): {"secs",
    "secs_min", "secs_max", "repeats", "spread_frac"}."""
    with torch.no_grad():
        probe = plan(x)
        return time_repeats(plan, x, repeats=repeats,
                            square=probe.shape == x.shape)


# Per-dtype conformance tolerances: the reference gate is elementwise
# 1e-4 in f32 (check_result.cu); bf16 carries ~1e-3 relative error by
# design (opt-in reduced precision) and int8 quantization ~1e-2, so a
# record names the gate of its own dtype.
DTYPE_TOL = {
    "float32": 1e-4,
    "f32": 1e-4,
    "bf16x3": 1e-4,  # three bf16 products recover f32-grade accuracy
    "bfloat16": 5e-3,
    "bf16": 5e-3,
    "int8": 5e-2,
}


def dtype_tolerance(dtype_name: Optional[str]) -> float:
    return DTYPE_TOL.get(str(dtype_name or "float32"), 1e-4)


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().to("cpu", torch.float32).numpy()
    return np.asarray(a, np.float32)


def conformance_fields(out, ref, dtype_name: Optional[str]) -> Dict:
    """Max relative error against an oracle (max |out - ref| / max |ref|)
    and the per-dtype gate."""
    out, ref = _host(out), _host(ref)
    denom = max(float(np.max(np.abs(ref))), 1e-30)
    err = float(np.max(np.abs(out - ref))) / denom
    tol = dtype_tolerance(dtype_name)
    return {
        "max_rel_err": err,
        "tol": tol,
        "dtype_for_tol": str(dtype_name or "float32"),
        "gate_ok": err <= tol,
    }


def _spread_fields(t: dict) -> Dict:
    """ms median + min/max + repeat count from a time_repeats dict."""
    return {
        "ms": t["secs"] * 1e3,
        "ms_min": t["secs_min"] * 1e3,
        "ms_max": t["secs_max"] * 1e3,
        "repeats": t["repeats"],
    }


def _bsr_record(bsr: BSR, dim: int, secs: float) -> Dict:
    b = bsr.b
    # the reference counts nnzb * b^2 * dim MACs (test_bsrmm.cu:168);
    # FLOPs are twice that
    flops = 2.0 * bsr.nnzb * b * b * dim
    bytes_moved = 4.0 * (
        bsr.nnzb * b * b  # blocks
        + bsr.nnzb * b * dim  # gathered B tiles
        + bsr.n_block_rows * b * dim  # C
    )
    return {
        "ms": secs * 1e3,
        "gflops": flops / secs / 1e9,
        "nnz_per_s": bsr.nnz_inside() / secs,
        "block_density": bsr.block_density(),
        "block_utilization": bsr.utilization(),
        "bytes": bytes_moved,
        "intensity_flop_per_byte": flops / bytes_moved,
        "achieved_gb_s": bytes_moved / secs / 1e9,
    }


def bench_synthetic_bsr(
    p: float, block_size: int, dim: int, impl: str = "bsr_pallas",
    n_block_rows: int = 1024, dtype=None, transb: int = 0, device=None,
) -> Dict:
    """test_bsrmm analog: seeded random BSR, one timed SpMM.

    transb=1: the operand arrives column-major, (dim, K), the
    reference's transB axis; the plan is wrapped in ops/plan.transb_plan,
    and the copy to row-major is timed inside the call (it is what a
    column-major caller pays)."""
    dev = resolve_device(device)
    bsr = random_bsr(p, n_block_rows, block_size=block_size, seed=1234)
    kw = {"dtype": _torch_dtype(dtype)} if dtype else {}
    t0 = time.perf_counter()
    plan = spmm_plan(bsr, impl=impl, device=dev, **kw)
    _sync(dev)
    plan_s = time.perf_counter() - t0
    x = _dense_operand(bsr.shape[1], dim)
    if transb:
        plan = transb_plan(plan)
        x = np.ascontiguousarray(x.T)
    t = _time_spread(plan, torch.as_tensor(x, device=dev))
    rec = _bsr_record(bsr, dim, t["secs"])
    rec.update(_spread_fields(t))
    rec.update(
        kind="synthetic_bsr", p=p, b=block_size, dim=dim, impl=impl,
        n=bsr.shape[0], nnzb=bsr.nnzb, transb=transb, plan_s=plan_s,
        dtype=dtype_name(dtype) if dtype else "float32",
        device=_device_name(dev),
    )
    return rec


def bench_synthetic_csr(
    p: float, dim: int, impl: str = "csr_xla", n_rows: int = 1 << 15,
    device=None,
) -> Dict:
    """test_csrmm analog (the reference uses 2^17 rows)."""
    dev = resolve_device(device)
    csr = random_csr(p, n_rows, seed=1234)
    t0 = time.perf_counter()
    plan = spmm_plan(csr, impl=impl, device=dev)
    _sync(dev)
    plan_s = time.perf_counter() - t0
    x = _dense_operand(csr.shape[1], dim)
    t = _time_spread(plan, torch.as_tensor(x, device=dev))
    secs = t["secs"]
    flops = 2.0 * csr.nnz * dim
    rec = {
        "kind": "synthetic_csr", "p": p, "dim": dim, "impl": impl,
        "n": csr.n_rows, "nnz": csr.nnz, "plan_s": plan_s,
        "gflops": flops / secs / 1e9, "nnz_per_s": csr.nnz / secs,
        "device": _device_name(dev),
    }
    rec.update(_spread_fields(t))
    return rec


def bench_graph(
    dataset: str, strategy: str = "rcmk", block_size: int = 128,
    dim: int = 128, impl: str = "hybrid", scale: float = 1.0,
    density_threshold: float = 0.05, dtype=None, n_windows: int = 1,
    device=None,
) -> Dict:
    """run_csrmm / run_bsrmm / divide analog on a (reordered) graph; an
    inference plan (grad=False)."""
    dev = resolve_device(device)
    csr = load_dataset(dataset, scale=scale)
    rcsr, _ = reorder(csr, strategy)
    metrics = block_metrics(rcsr, [block_size])[block_size]
    t_plan0 = time.perf_counter()

    kw = dict(grad=False, device=dev)
    if dtype:
        kw["dtype"] = _torch_dtype(dtype)
    if impl == "windowed":
        from spmm_denseblock_tpu_torch.formats.windowed import divide_windowed
        from spmm_denseblock_tpu_torch.ops.windowed_spmm import windowed_spmm_plan

        wt = divide_windowed(rcsr, tile_rows=256, window=1024, n_windows=n_windows)
        plan = windowed_spmm_plan(wt, **kw)
        extra = {
            "captured_nnz": wt.captured_nnz(),
            "remainder_nnz": wt.remainder.nnz,
            "n_tiles": wt.n_tiles,
        }
    elif impl == "hybrid":
        hyb = divide(rcsr, block_size, density_threshold)
        plan = spmm_plan(hyb, impl="hybrid", **kw)
        extra = {
            "dense_nnzb": hyb.dense.nnzb,
            "remainder_nnz": hyb.remainder.nnz,
            "density_threshold": density_threshold,
        }
    elif impl.startswith("bsr"):
        bsr = csr_to_bsr(rcsr, block_size)
        plan = spmm_plan(bsr, impl=impl, **kw)
        extra = {"nnzb": bsr.nnzb}
    else:
        plan = spmm_plan(rcsr, impl=impl, **kw)
        extra = {}
    _sync(dev)
    plan_s = time.perf_counter() - t_plan0

    x = _dense_operand(rcsr.n_cols, dim)
    t = _time_spread(plan, torch.as_tensor(x, device=dev))
    secs = t["secs"]
    flops = 2.0 * csr.nnz * dim
    rec = {
        "kind": "graph", "dataset": dataset, "strategy": strategy,
        "b": block_size, "dim": dim, "impl": impl, "scale": scale,
        "dtype": dtype_name(dtype) if dtype else "float32",
        "n": csr.n_rows, "nnz": csr.nnz, "plan_s": plan_s,
        "gflops": flops / secs / 1e9, "nnz_per_s": csr.nnz / secs,
        "block_density": metrics["density"],
        "block_utilization": metrics["utilization"],
        # which graph this measured (a synthetic stand-in says so) and
        # its measured structure
        "source": dataset_provenance(dataset),
        "graph_stats": graph_stats(csr, sample=500),
        "device": _device_name(dev),
    }
    rec.update(_spread_fields(t))
    rec.update(extra)
    return rec


def _world_seconds(fn, iters: int, dev: torch.device) -> float:
    """Seconds per call of fn on this rank, every rank starting together,
    each call ended on the card (the host clock: a call spans the ranks'
    exchange)."""
    import torch.distributed as dist

    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        _sync(dev)
    return (time.perf_counter() - t0) / iters


def _scaling_rank(rank: int, nd: int, p, block_size, dim, n_block_rows, strategy,
                  device_type) -> dict:
    from spmm_denseblock_tpu_torch.parallel import dist_bsr_spmm_plan, make_mesh_1d
    from spmm_denseblock_tpu_torch.parallel.exchange import rank_device

    dev = rank_device("cpu" if device_type == "cpu" else None)
    bsr = random_bsr(p, n_block_rows, block_size=block_size, seed=1234)
    plan = dist_bsr_spmm_plan(bsr, mesh=make_mesh_1d(nd, device_type=device_type),
                              strategy=strategy, device=dev)
    x = torch.as_tensor(_dense_operand(bsr.shape[1], dim), device=dev)
    with torch.no_grad():
        plan(x)  # warm
        secs = _world_seconds(lambda: plan(x), 8, dev)
    return {"secs": secs, "nnz": bsr.nnz_inside(), "nnzb": bsr.nnzb,
            "n_cols": bsr.shape[1]}


def bench_scaling(
    n_devices_list: Sequence[int],
    p: float = 1.6e-2,
    block_size: int = 64,
    dim: int = 256,
    n_block_rows: int = 1024,
    strategy: str = "allgather",
    device=None,
) -> Dict:
    """Distributed SpMM scaling (dist_bsr_spmm_plan, local_impl "xla", on
    a 1D row mesh) beside the link model it must be read against
    (parallel/comms.py). Each point is a world of nd ranks
    (parallel/world.run_world) timing 8 calls (JAX's time_synced); its
    time is the slowest rank's.

    The ranks of one machine share its cores, and the ranks of one card
    share the card: linear nnz/s scaling is impossible there. What such
    a run can read is RETENTION = rate(n) / rate(1), the share of the
    one-rank rate that survives partitioning and the exchanges (ideal
    1.0); it is not scaling. `efficiency` is kept for runs with a card a
    rank. Each point also carries the H100 NVLink model's prediction for
    the same shape (`ici_model_*`, the JAX record's keys). device: None
    is the card (ranks over NCCL with a GPU each, else over gloo sharing
    it; RuntimeError without a GPU), "cpu" CPU ranks."""
    from spmm_denseblock_tpu_torch.parallel.comms import efficiency_model
    from spmm_denseblock_tpu_torch.parallel.world import backend_for, run_world

    dev = resolve_device(device)
    points = []
    base = rate1 = None
    nnzb = None
    for nd in n_devices_list:
        res = run_world(_scaling_rank, nd, backend=backend_for(dev, nd),
                        args=(p, block_size, dim, n_block_rows, strategy, dev.type),
                        timeout_s=900.0,
                        threads=1 if dev.type == "cpu" else 2)
        secs = max(r["secs"] for r in res)
        nnz, nnzb, n_cols = res[0]["nnz"], res[0]["nnzb"], res[0]["n_cols"]
        rate = nnz / secs
        if base is None:
            base = rate / nd if nd else rate
            rate1 = rate
        model = efficiency_model(strategy if strategy != "auto" else "allgather",
                                 nd, nnzb, block_size, n_cols, dim)
        points.append({
            "devices": nd,
            "ms": secs * 1e3,
            "nnz_per_s": rate,
            "efficiency": rate / (nd * base) if base else 1.0,
            "retention": rate / rate1 if rate1 else 1.0,
            "ici_model_efficiency": model["efficiency"],
            "ici_model_t_comp_us": model["t_comp_us"],
            "ici_model_t_comm_us": model["t_comm_us"],
        })
    return {
        "kind": "scaling", "p": p, "b": block_size, "dim": dim,
        "nnzb": nnzb, "strategy": strategy, "points": points,
        "device": _device_name(dev),
        "note": (
            "ranks share one machine's cores, or one card: read `retention` "
            "(ideal 1.0), which is not scaling, not `efficiency`; `ici_model_*` "
            "is the H100 NVLink model's prediction for this shape "
            "(parallel/comms.py)"
        ),
    }


def _train_scaling_rank(rank: int, nd: int, p, block_size, dims, n_block_rows,
                        strategy, iters, seed, device_type) -> float:
    from spmm_denseblock_tpu_torch.parallel import make_mesh_1d
    from spmm_denseblock_tpu_torch.parallel.exchange import rank_device
    from spmm_denseblock_tpu_torch.parallel.train import make_dist_train_step

    dev = rank_device("cpu" if device_type == "cpu" else None)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    bsr = random_bsr(p, n_block_rows, block_size=block_size, seed=1234)
    n = bsr.shape[0]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    y = rng.integers(0, dims[-1], size=n).astype(np.int32)
    mask = np.ones(n, np.float32)
    params, opt_state, step = make_dist_train_step(
        bsr, make_mesh_1d(nd, device_type=device_type), list(dims),
        block_size=block_size, strategy=strategy, seed=seed, device=dev)
    x, y, mask = (torch.as_tensor(a) for a in (x, y, mask))
    state = [params, opt_state]

    def one_step():
        state[0], state[1], m = step(state[0], state[1], x, y, mask)
        float(m["loss"])  # the loss read back: every step ends on the host

    one_step()  # warm
    return _world_seconds(one_step, iters, dev)


def bench_train_scaling(
    n_devices_list: Sequence[int],
    p: float = 1.6e-2,
    block_size: int = 64,
    dims: Sequence[int] = (256, 256, 32),
    n_block_rows: int = 1024,
    strategy: str = "allgather",
    iters: int = 4,
    seed: int = 0,
    device=None,
) -> Dict:
    """Distributed TRAIN-STEP scaling, bench_scaling's model-level
    counterpart: one whole GCN step (parallel/train.make_dist_train_step:
    the distributed SpMM forward and backward, the dense layers, Adam)
    a point, on a 1D row mesh of nd ranks, each step's loss read back.
    The same reading as bench_scaling: `retention` = step rate(n) /
    rate(first point), ideal 1.0, is the reading where ranks share a
    machine or a card, and it is not scaling. device as bench_scaling."""
    from spmm_denseblock_tpu_torch.parallel.world import backend_for, run_world

    dev = resolve_device(device)
    points = []
    rate1 = nd1 = nnzb = None
    for nd in n_devices_list:
        res = run_world(_train_scaling_rank, nd, backend=backend_for(dev, nd),
                        args=(p, block_size, tuple(dims), n_block_rows, strategy,
                              iters, seed, dev.type), timeout_s=900.0,
                        threads=1 if dev.type == "cpu" else 2)
        secs = max(res)
        rate = 1.0 / secs
        if rate1 is None:
            rate1, nd1 = rate, nd
        points.append({
            "devices": nd,
            "ms_per_step": secs * 1e3,
            "steps_per_s": rate,
            # both normalized to the first point (baseline_devices): the
            # rate(1)-relative readings only when the list starts at 1
            "efficiency": (rate / nd) / (rate1 / nd1),
            "retention": rate / rate1,
        })
    if n_devices_list:
        nnzb = random_bsr(p, n_block_rows, block_size=block_size, seed=1234).nnzb
    return {
        "kind": "train_scaling", "p": p, "b": block_size, "dims": list(dims),
        "nnzb": nnzb, "strategy": strategy, "baseline_devices": nd1,
        "points": points, "device": _device_name(dev),
        "note": (
            "ranks share one machine's cores, or one card: read `retention` "
            "(rate vs the baseline_devices point, ideal 1.0), which is not "
            "scaling, not `efficiency`"
        ),
    }


def bench_train_step(
    dataset: str = "ogbn-arxiv",
    strategy: str = "rabbit",
    dims: Sequence[int] = (128, 256, 40),
    impl: str = "auto",
    block_size: int = 128,
    scale: float = 1.0,
    iters: int = 10,
    seed: int = 0,
    device=None,
) -> Dict:
    """End-to-end GCN training-step latency on a (reordered) graph: Adam
    at lr 1e-2 (JAX's optax.adam(1e-2)) through make_train_step. Steps
    chain through the parameters, which each step updates in place; on
    the card the `iters` steps run between two CUDA events."""
    from spmm_denseblock_tpu_torch.models import (
        gcn_apply,
        init_gcn,
        make_train_step,
        sym_norm_adjacency,
    )

    dev = resolve_device(device)
    csr = load_dataset(dataset, scale=scale)
    rcsr, _ = reorder(csr, strategy)
    adj = sym_norm_adjacency(rcsr)
    spmm = spmm_plan(adj, impl=impl, block_size=block_size, feat_dim=max(dims),
                     device=dev)
    params = init_gcn(list(dims), torch.Generator().manual_seed(seed), device=dev)
    step, init_state = make_train_step(
        gcn_apply, spmm, functools.partial(torch.optim.Adam, lr=1e-2))
    opt_state = init_state(params)

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(
        rng.standard_normal((csr.n_rows, dims[0])).astype(np.float32), device=dev)
    y = torch.as_tensor(rng.integers(0, dims[-1], size=csr.n_rows), device=dev)
    mask = torch.ones(csr.n_rows, device=dev)

    def one_step():
        step(params, opt_state, x, y, mask)

    if dev.type == "cuda":
        secs = cuda_ms(one_step, iters, warmup=1) / 1e3
    else:
        one_step()  # warm
        t0 = time.perf_counter()
        for _ in range(iters):
            one_step()
        secs = (time.perf_counter() - t0) / iters

    return {
        "kind": "train_step", "dataset": dataset, "strategy": strategy,
        "impl": impl, "dims": list(dims), "scale": scale,
        "n": csr.n_rows, "nnz": csr.nnz, "ms_per_step": secs * 1e3,
        "edges_per_s": csr.nnz * 2 * (len(dims) - 1) / secs,  # fwd+bwd spmm
        "device": _device_name(dev),
    }
