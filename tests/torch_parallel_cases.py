"""Rank side of the distributed parity tests (tests/test_torch_parallel_*.py).

Each test file spawns one world of 4 CPU ranks over gloo
(``parallel.world.run_world``) that runs every case of the file through
``run_cases``; its parametrized tests then read the results and compare
them with the JAX package's plans on the same mesh size. This module
imports no jax: every spawned rank imports it by name.

A case is a dict: name, kind ("bsr", "csr", "hybrid", "windowed",
"sddmm"), mat (a port matrix), x (and y for SDDMM) as numpy, kw (the
plan's keyword arguments, dtypes by name), mesh ("1d": 4 ranks, "2d":
(2, 2) with the feature axis), and optionally raises (an exception
class name the plan must raise).
"""

from __future__ import annotations

import traceback

import numpy as np
import torch


def port_bsr(j):
    from spmm_denseblock_tpu_torch.formats.bsr import BSR

    return BSR(np.asarray(j.block_rows), np.asarray(j.block_cols),
               np.asarray(j.blocks), tuple(j.shape), int(j.block_size), int(j.nnzb))


def port_csr(j):
    from spmm_denseblock_tpu_torch.formats.csr import CSR

    return CSR(np.asarray(j.indptr), np.asarray(j.indices),
               None if j.data is None else np.asarray(j.data), tuple(j.shape))


def port_hybrid(j):
    from spmm_denseblock_tpu_torch.formats.hybrid import Hybrid

    return Hybrid(port_bsr(j.dense), port_csr(j.remainder), tuple(j.shape))


def port_windowed(j):
    from spmm_denseblock_tpu_torch.formats.windowed import Windowed

    return Windowed(np.asarray(j.tiles), np.asarray(j.win_idx), port_csr(j.remainder),
                    tuple(j.shape), int(j.tile_rows), int(j.window))


def _kw(kw: dict) -> dict:
    out = dict(kw)
    if out.get("dtype") is not None:
        out["dtype"] = getattr(torch, out["dtype"])
    return out


def _run(case: dict, meshes: dict) -> dict:
    from spmm_denseblock_tpu_torch.ops.plan import Plan, run
    from spmm_denseblock_tpu_torch.parallel import (
        dist_bsr_spmm_plan,
        dist_csr_spmm_plan,
        dist_hybrid_spmm_plan,
        dist_sddmm_plan,
        dist_windowed_spmm_plan,
    )
    from spmm_denseblock_tpu_torch.parallel.exchange import (
        RowStripe,
        dist_info,
        gather_output,
        operand_rows,
    )
    from spmm_denseblock_tpu_torch.parallel.spmm import (
        gather_edges,
        layout_tag,
        plan_strategy,
        strategy_of,
    )

    build = {"bsr": dist_bsr_spmm_plan, "csr": dist_csr_spmm_plan,
             "hybrid": dist_hybrid_spmm_plan, "windowed": dist_windowed_spmm_plan,
             "sddmm": dist_sddmm_plan}[case["kind"]]
    kw = _kw(case.get("kw", {}))
    mesh = meshes[case.get("mesh", "1d")]
    if case.get("raises"):
        try:
            build(case["mat"], mesh=mesh, device="cpu", **kw)
        except Exception as e:  # noqa: BLE001 - the case names the class
            return {"raised": type(e).__name__, "msg": str(e)}
        return {"raised": None}
    plan = build(case["mat"], mesh=mesh, device="cpu", **kw)
    bufs = list(plan.buffers())
    res = {"is_plan": isinstance(plan, Plan),
           "devices": sorted({t.device.type for t in bufs}), "n_buffers": len(bufs)}
    x = torch.as_tensor(case["x"])
    if case["kind"] == "sddmm":
        y = torch.as_tensor(case["y"])
        res["got"] = gather_edges(plan, plan(x, y)).numpy()
        return res
    c = plan(x)
    res["got"] = gather_output(plan, c).numpy()
    res["plain_equal"] = bool(torch.equal(run(plan, x, plain=True), c))
    info = dist_info(plan)
    if info.tp == 1:
        lo, hi = operand_rows(plan)
        res["stripe_equal"] = bool(torch.equal(plan(RowStripe(x[lo:hi])), c))
    if case["kind"] == "bsr":
        res["tag"] = layout_tag(plan)
        res["strategy"] = strategy_of(plan)
        res["plan_strategy"] = plan_strategy(
            case["mat"], info.n, **{k: kw[k] for k in ("strategy", "halo", "balance")
                                    if k in kw})
    return res


def run_cases(rank: int, n: int, cases: list) -> dict:
    """Every case on this rank; rank 0 returns the results, the others
    only their errors (a case's failure on any rank fails its test)."""
    from spmm_denseblock_tpu_torch.parallel import make_mesh, make_mesh_1d

    meshes = {"1d": make_mesh_1d(4, device_type="cpu"),
              "2d": make_mesh((2, 2), device_type="cpu")}
    out = {}
    for case in cases:
        try:
            out[case["name"]] = _run(case, meshes)
        except Exception:  # noqa: BLE001 - reported to the case's test
            out[case["name"]] = {"error": f"rank {rank}:\n{traceback.format_exc()}"}
    if rank == 0:
        return out
    return {k: v for k, v in out.items() if "error" in v}


def world_results(cases: list) -> dict:
    """Run `cases` in one world of 4 gloo ranks on the CPU; the results
    by case name, with any rank's error folded in."""
    from spmm_denseblock_tpu_torch.parallel.world import run_world

    per_rank = run_world(run_cases, 4, args=(cases,), timeout_s=240.0)
    results = per_rank[0]
    for errs in per_rank[1:]:
        for name, v in errs.items():
            results[name] = v
    return results


def multihost_case(rank: int, n: int, store: str) -> dict:
    """parallel.multihost in a world of n: initialize twice (the second
    a no-op), pod_mesh's shapes and refusal, is_coordinator."""
    import torch.distributed as dist

    from spmm_denseblock_tpu_torch.parallel.multihost import (
        initialize,
        is_coordinator,
        pod_mesh,
    )

    initialize(f"file://{store}", n, rank, timeout_s=120.0)
    group = dist.group.WORLD
    initialize(f"file://{store}", n, rank, timeout_s=120.0)
    out = {"same_group": dist.group.WORLD is group, "world": dist.get_world_size(),
           "coordinator": is_coordinator()}
    try:
        mesh = pod_mesh(device_type="cpu")
        out["pod_shape"] = tuple(mesh.mesh.shape)
        out["pod_names"] = tuple(mesh.mesh_dim_names)
        out["rows_1"] = tuple(pod_mesh(1, device_type="cpu").mesh.shape)
        try:
            pod_mesh(n + 1, device_type="cpu")
            out["refused"] = None
        except ValueError as e:
            out["refused"] = str(e)
    finally:
        dist.destroy_process_group()
    return out
