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

import functools
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
    only their errors (a case's failure on any rank fails its test). The
    "1d" mesh holds all n ranks; a world of 4 has the "2d" one too."""
    from spmm_denseblock_tpu_torch.parallel import make_mesh, make_mesh_1d

    meshes = {"1d": make_mesh_1d(n, device_type="cpu")}
    if n == 4:
        meshes["2d"] = make_mesh((2, 2), device_type="cpu")
    out = {}
    for case in cases:
        try:
            out[case["name"]] = _run(case, meshes)
        except Exception:  # noqa: BLE001 - reported to the case's test
            out[case["name"]] = {"error": f"rank {rank}:\n{traceback.format_exc()}"}
    if rank == 0:
        return out
    return {k: v for k, v in out.items() if "error" in v}


def world_results(cases: list, n: int = 4) -> dict:
    """Run `cases` in one world of n gloo ranks on the CPU; the results
    by case name, with any rank's error folded in."""
    from spmm_denseblock_tpu_torch.parallel.world import run_world

    per_rank = run_world(run_cases, n, args=(cases,), timeout_s=240.0)
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


# -- training (tests/test_torch_dist_train.py) --------------------------------


def _whole_leaves(step, tree) -> list:
    from spmm_denseblock_tpu_torch.models.checkpoint import tree_leaves

    return [t.cpu().numpy() for t in tree_leaves(step.whole(tree))]


def train_case(case: dict, meshes: dict, device="cpu") -> dict:
    """3 steps of make_dist_train_step from the case's whole weights:
    the losses and accuracies, the step-0 gradients and the parameters
    after the 3 steps (gathered whole), the exchange bytes of step 0."""
    from spmm_denseblock_tpu_torch.models.checkpoint import tree_map
    from spmm_denseblock_tpu_torch.parallel.train import make_dist_train_step

    params, opt, step = make_dist_train_step(
        case["adj"], meshes[case["mesh"]], case["dims"], model=case["model"],
        block_size=case.get("block_size", 16), strategy=case.get("strategy", "allgather"),
        params=case["params"], device=device)
    out = {"losses": [], "accs": [], "chained": step.chained}
    for i in range(3):
        params, opt, m = step(params, opt, case["x"], case["y"], case["mask"])
        out["losses"].append(float(m["loss"]))
        out["accs"].append(float(m["acc"]))
        if i == 0:
            out["grads0"] = _whole_leaves(step, tree_map(lambda t: t.grad, params))
            out["bytes0"] = m["exchange_bytes"]
    out["params3"] = _whole_leaves(step, params)
    return out


def _grad_of(x: torch.Tensor, fn) -> torch.Tensor:
    x = x.clone().requires_grad_(True)
    fn(x).backward()
    return x.grad


def exchange_grad_cases(rank: int, n: int, device: str) -> dict:
    """The backward pass of each exchange of parallel/exchange.py on this
    rank, against its plain version: each rank r weighs its output by
    W_r (seeded by r), so the gradient of sum_r <W_r, out_r> that rank s
    holds is known in closed form. Returns name -> (autograd's, plain)."""
    import torch.distributed as dist

    from spmm_denseblock_tpu_torch.parallel import exchange as exch
    from spmm_denseblock_tpu_torch.parallel import make_mesh

    def seeded(shape, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=g).to(device)

    mesh = make_mesh((2, n // 2), device_type="cpu" if device == "cpu" else "cuda")
    world = dist.group.WORLD
    c, F = 5, 6
    x = seeded((c, F), rank)
    W = [seeded((n * c, F), 100 + r) for r in range(n)]
    out = {}
    out["all_gather_rows"] = (
        _grad_of(x, lambda t: (exch.all_gather_rows(t, world) * W[rank]).sum()),
        sum(w[rank * c:(rank + 1) * c] for w in W))
    Ws = [seeded((c, F), 200 + r) for r in range(n)]
    for k in (1, -2):
        out[f"shift {k}"] = (
            _grad_of(x, lambda t: (exch.shift(t, world, k, tag=7).wait() * Ws[rank]).sum()),
            Ws[(rank + k) % n])
    # the ring's schedule: the next step's shift posted before this
    # step's work, the received chunk shifted on
    out["ring"] = (
        _grad_of(x, lambda t: _ring_chain(exch, t, world, n, Ws[rank])),
        sum(Ws[(rank + s) % n] for s in range(n)))
    Wa = seeded((c, F), 300)  # the same on every rank: they share one loss
    out["all_reduce_sum"] = (
        _grad_of(x, lambda t: (exch.all_reduce_sum(t, world) * Wa).sum()), Wa)
    # the col group of a (2, n/2) mesh: rank j of it holds columns slice j
    col, tp = mesh.get_group("col"), n // 2
    fj = mesh.get_local_rank("col")
    Fc = 7
    fs = -(-Fc // tp)
    c0, c1 = min(fj * fs, Fc), min(fj * fs + fs, Fc)
    xc = seeded((c, Fc), 400 + mesh.get_local_rank("row"))[:, c0:c1]
    Wc = [seeded((c, Fc), 500 + r) for r in range(n)]
    peers = dist.get_process_group_ranks(col)
    out["gather_columns"] = (
        _grad_of(xc, lambda t: (exch.gather_columns(t, col, Fc) * Wc[rank]).sum()),
        sum(Wc[r][:, c0:c1] for r in peers))
    return {k: (a.cpu(), b.cpu()) for k, (a, b) in out.items()}


def _ring_chain(exch, t, group, n, w):
    chunk, total = t, 0.0
    for s in range(n):
        nxt = exch.shift(chunk, group, 1, tag=s) if s < n - 1 else None
        total = total + (chunk * w).sum()
        if nxt is not None:
            chunk = nxt.wait()
    return total


def run_train_cases(rank: int, n: int, cases: list) -> dict:
    """Every training case on this rank (meshes "4x1" and "2x2"), then
    the exchanges' backward cases; rank 0 returns its results, the others
    their losses (the loss must be the same on every rank) and errors."""
    from spmm_denseblock_tpu_torch.parallel import make_mesh

    meshes = {"4x1": make_mesh((4, 1), device_type="cpu"),
              "2x2": make_mesh((2, 2), device_type="cpu")}
    out = {}
    for case in cases:
        try:
            out[case["name"]] = train_case(case, meshes)
        except Exception:  # noqa: BLE001 - reported to the case's test
            out[case["name"]] = {"error": f"rank {rank}:\n{traceback.format_exc()}"}
    try:
        out["exchanges"] = exchange_grad_cases(rank, n, "cpu")
    except Exception:  # noqa: BLE001
        out["exchanges"] = {"error": f"rank {rank}:\n{traceback.format_exc()}"}
    if rank == 0:
        return out
    return {k: ({"losses": v["losses"]} if "losses" in v else v) for k, v in out.items()
            if k != "exchanges" or "error" in v}


# -- sharded checkpoints (tests/test_torch_checkpoint_dist.py) ----------------


def _resume_case(root: str, model: str, shape, wait: bool, device="cpu") -> dict:
    """Train 2 steps, save, take step 3; restore into a fresh template
    (other weights, an optimizer with no state) and take step 3 again."""
    from spmm_denseblock_tpu_torch.models.checkpoint import tree_leaves
    from spmm_denseblock_tpu_torch.models.checkpoint_dist import (
        make_manager,
        restore_dist_checkpoint,
        save_dist_checkpoint,
    )
    from spmm_denseblock_tpu_torch.parallel import make_mesh
    from spmm_denseblock_tpu_torch.parallel.train import make_dist_train_step, random_problem

    mesh = make_mesh(shape, device_type="cpu" if device == "cpu" else "cuda")
    dims = [8, 12, 4]
    adj, x, y, mask = random_problem(96, dims, p=0.06, seed=11)
    build = functools.partial(make_dist_train_step, adj, mesh, dims, model=model,
                              block_size=16, device=device)
    params, opt, step = build(seed=3)
    mgr = make_manager(root, max_to_keep=2)
    for i in range(2):
        params, opt, m = step(params, opt, x, y, mask)
        save_dist_checkpoint(mgr, i + 1, step.state(params, opt), wait=wait)
    params, opt, m3 = step(params, opt, x, y, mask)
    p2, o2, s2 = build(seed=99)
    _, k = restore_dist_checkpoint(mgr, s2.state(p2, o2))
    p2, o2, m3b = s2(p2, o2, x, y, mask)
    return {"step": k, "loss_equal": float(m3["loss"]) == float(m3b["loss"]),
            "params_equal": all(torch.equal(a.detach(), b.detach()) for a, b in
                                zip(tree_leaves(params), tree_leaves(p2))),
            "steps": mgr.all_steps()}


def checkpoint_cases(rank: int, n: int, root: str) -> dict:
    """The sharded round trip, retention and latest step, missing steps,
    and bit-exact resumes (sync and async saves) on this rank."""
    from pathlib import Path

    from torch.distributed.tensor import DTensor, Shard

    from spmm_denseblock_tpu_torch.models.checkpoint_dist import (
        make_manager,
        restore_dist_checkpoint,
        save_dist_checkpoint,
    )
    from spmm_denseblock_tpu_torch.parallel import make_mesh

    mesh = make_mesh((2, 2), device_type="cpu")
    g = torch.Generator().manual_seed(7)
    w_whole = torch.randn(256, 64, generator=g)  # shards of 32 KiB: DCP's
    # per-tensor overhead (~1.5 KB) is small beside them
    b = torch.randn(16, generator=g)
    r, c = mesh.get_local_rank("row"), mesh.get_local_rank("col")
    place = [Shard(0), Shard(1)]

    def state(w_local, b, mu_local):
        return {"params": {"w": DTensor.from_local(w_local, mesh, place, run_check=False),
                           "b": b},
                "opt": {"mu": DTensor.from_local(mu_local, mesh, place, run_check=False)}}

    mine = w_whole[r * 128:(r + 1) * 128, c * 32:(c + 1) * 32].clone()
    out = {}
    mgr = make_manager(f"{root}/roundtrip", max_to_keep=2)
    save_dist_checkpoint(mgr, 5, state(mine, b, mine * 2))
    tmpl = state(torch.zeros(128, 32), torch.zeros(16), torch.zeros(128, 32))
    restored, step = restore_dist_checkpoint(mgr, tmpl)
    rw = restored["params"]["w"]
    out["roundtrip"] = {
        "step": step,
        "w_equal": torch.equal(rw.to_local(), mine),
        "mu_equal": torch.equal(restored["opt"]["mu"].to_local(), mine * 2),
        "b_equal": torch.equal(restored["params"]["b"], b),
        "placements": tuple(rw.placements) == tuple(place),
        "in_place": rw.to_local().data_ptr() == tmpl["params"]["w"].to_local().data_ptr(),
        "file_bytes": {p.name: p.stat().st_size
                       for p in Path(mgr.step_dir(5)).glob("*.distcp")},
        "whole_w_bytes": w_whole.numel() * 4, "shard_bytes": mine.numel() * 4,
    }
    mgr = make_manager(f"{root}/retention", max_to_keep=2)
    for s in (1, 2, 3):
        save_dist_checkpoint(mgr, s, state(mine + s, b, mine))
    latest, steps = mgr.latest_step(), mgr.all_steps()
    _, got = restore_dist_checkpoint(mgr, tmpl, step=None)
    _, got2 = restore_dist_checkpoint(mgr, tmpl, step=2)
    out["retention"] = {"latest": latest, "steps": steps, "restored": got,
                        "restored_2": got2,
                        "w2_equal": torch.equal(tmpl["params"]["w"].to_local(), mine + 2)}
    raised = []
    for label, m, s in (("empty", make_manager(f"{root}/empty"), None),
                        ("absent step", mgr, 7)):
        try:
            restore_dist_checkpoint(m, tmpl, step=s)
            raised.append((label, None))
        except FileNotFoundError:
            raised.append((label, "FileNotFoundError"))
    out["missing"] = raised
    out["resume_gin_2x2"] = _resume_case(f"{root}/gin", "gin", (2, 2), True)
    out["resume_gcn_4x1_async"] = _resume_case(f"{root}/gcn", "gcn", (4, 1), False)
    return out
