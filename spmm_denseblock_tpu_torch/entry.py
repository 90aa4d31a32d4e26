"""Driver entry points (twin of ``__graft_entry__``).

entry()              -> (fn, (params, x)): the flagship model, a GCN over
                        the BSR SpMM plan, trainable (the plan is built
                        with the default grad=True, so its backward runs
                        Aᵀ's kernel);
dryrun_multichip(n)  -> a world of n ranks on an ("row", "col") mesh
                        runs every pass of the JAX package's dry run: the
                        distributed training step (ring, hybrid, and
                        halo at a realistic stripe size), the int8
                        serving plans and the kernel-local ring plans
                        (f32 and int8), the balanced halo; then the
                        readiness harness (bench/readiness.py) at its
                        minimal combination.

    fn, (params, x) = entry()
    out = fn(params, x)            # (512, 16) logits

    python -m spmm_denseblock_tpu_torch.entry [--device cpu] [--dryrun N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def entry(device=None):
    """(fn, (params, x)): fn(params, x) is the GCN forward over the plan;
    n=512, dims [32, 64, 16], bsr_pallas at b=128, seeds as the JAX
    entry (weights from a torch.Generator seeded 0, which draws other
    numbers than jax.random.PRNGKey(0)). device: None is the card."""
    from spmm_denseblock_tpu_torch.formats.csr import random_csr
    from spmm_denseblock_tpu_torch.models import gcn_apply, init_gcn, sym_norm_adjacency
    from spmm_denseblock_tpu_torch.ops import spmm_plan
    from spmm_denseblock_tpu_torch.ops._device import resolve_device

    device = resolve_device(device)

    n, dims = 512, [32, 64, 16]
    adj = sym_norm_adjacency(random_csr(0.02, n, seed=0, values="ones"))
    spmm = spmm_plan(adj, impl="bsr_pallas", block_size=128, device=device)
    params = init_gcn(dims, generator=torch.Generator().manual_seed(0),
                      device=device)
    x = np.random.default_rng(0).standard_normal((n, dims[0])).astype(np.float32)

    def fn(params, x):
        return gcn_apply(params, spmm, torch.as_tensor(x, device=device))

    return fn, (params, x)


def _mesh_shape(n: int):
    return (n // 2, 2) if n >= 4 and n % 2 == 0 else (n, 1)


def _rel(got, want) -> float:
    got = got.detach().cpu().double().numpy()
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-9))


def _dryrun_rank(rank: int, n: int, device_type: str, realistic_block_rows: int) -> list:
    """Every pass of the dry run on one rank; asserts its checks and
    returns its lines."""
    from spmm_denseblock_tpu_torch.convert.csr2bsr import csr_to_bsr
    from spmm_denseblock_tpu_torch.convert.divide import divide
    from spmm_denseblock_tpu_torch.formats.csr import CSR
    from spmm_denseblock_tpu_torch.ops.reference import spmm_scipy
    from spmm_denseblock_tpu_torch.parallel import make_mesh, make_mesh_1d
    from spmm_denseblock_tpu_torch.parallel.exchange import gather_output
    from spmm_denseblock_tpu_torch.parallel.spmm import (
        dist_bsr_spmm_plan,
        dist_csr_spmm_plan,
        plan_strategy,
        strategy_of,
    )
    from spmm_denseblock_tpu_torch.parallel.train import make_dist_train_step, random_problem

    device = "cpu" if device_type == "cpu" else None
    if device_type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    shape = _mesh_shape(n)
    mesh = make_mesh(shape, device_type=device_type)
    lines = []

    def train(adj, tag, **kw):
        params, opt_state, step = make_dist_train_step(adj, mesh, dims, model="gcn",
                                                       device=device, **kw)
        params, opt_state, metrics = step(params, opt_state, x, y, mask)
        loss = float(metrics["loss"])
        assert np.isfinite(loss), (tag, loss)
        return loss

    dims = [8, 16, 4]
    # JAX's 16 nodes a row rank, but at least 64: at 32 (a (2, 2) mesh)
    # every block of the graph passes the hybrid's density threshold and
    # its remainder is empty
    adj, x, y, mask = random_problem(16 * max(shape[0], 4), dims, p=0.1, seed=0)
    loss = train(adj, "ring", block_size=16, strategy="ring")
    lines.append(f"dryrun_multichip({n}): mesh={shape} loss={loss:.4f} ok")

    # hybrid: dense stripes + the distributed ELL remainder, the
    # aggregation path for gather-bound graphs
    hyb = divide(adj, 16, 0.08)
    assert hyb.dense.nnzb > 0 and hyb.remainder.nnz > 0
    loss = train(hyb, "hybrid", block_size=16)
    lines.append(f"dryrun_hybrid_ell: mesh={shape} loss={loss:.4f} ok")

    # int8 serving: quantized tiers, int8 over every collective, and the
    # two-level compacted ELL gathers (forward only)
    dense_op = np.asarray(x, np.float32)
    want = spmm_scipy(adj, dense_op)
    bsr16 = csr_to_bsr(adj, 16)
    with torch.no_grad():
        for label, plan in (
            ("bsr_int8", dist_bsr_spmm_plan(bsr16, mesh=mesh, dtype=torch.int8,
                                            calibration=dense_op, device=device)),
            ("ell_int8_compact", dist_csr_spmm_plan(adj, mesh=mesh, dtype=torch.int8,
                                                    compact="force", compact_slots=128,
                                                    device=device)),
        ):
            rel = _rel(gather_output(plan, plan(dense_op)), want)
            assert rel < 5e-2, (label, rel)
            lines.append(f"dryrun_{label}: mesh={shape} rel={rel:.1e} ok")

        # the port's kernels inside the ring's stripes, f32 and int8
        for label, kw in (
            ("ring_pallas", dict(strategy="ring", local_impl="pallas")),
            ("ring_pallas_int8", dict(strategy="ring", local_impl="pallas",
                                      dtype=torch.int8, calibration=dense_op)),
        ):
            plan = dist_bsr_spmm_plan(bsr16, mesh=mesh, device=device, **kw)
            rel = _rel(gather_output(plan, plan(dense_op)), want)
            tol = 5e-2 if "int8" in label else 1e-5
            assert rel < tol, (label, rel)
            lines.append(f"dryrun_{label}: mesh={shape} rel={rel:.1e} ok")

        # a banded adjacency with a density gradient: uniform stripes are
        # imbalanced and LPT would lose halo eligibility, so "auto" must
        # take halo on contiguous equal-load boundaries, exactly. Over
        # fewer than 4 row ranks the plan never takes halo (JAX's neither):
        # there the pass runs on the 1D mesh of all n ranks
        halo_mesh, n_row = mesh, shape[0]
        if n_row < 4:
            halo_mesh, n_row = make_mesh_1d(n, device_type=device_type), n
        nbal = 16 * n_row * 8
        rows_l, cols_l = [], []
        for r in range(nbal):
            for jo in range(6 if r < nbal // 3 else 2):
                rows_l.append(r)
                cols_l.append(min(nbal - 1, max(0, r - 3 + jo)))
        csr_b = CSR.from_coo(np.array(rows_l), np.array(cols_l), None, (nbal, nbal))
        bsr_b = csr_to_bsr(csr_b, 8)
        xb = np.random.default_rng(3).standard_normal((nbal, 12)).astype(np.float32)
        plan_b = dist_bsr_spmm_plan(bsr_b, mesh=halo_mesh, strategy="auto", device=device)
        assert strategy_of(plan_b) == "halo", strategy_of(plan_b)
        assert plan_strategy(bsr_b, n_row, "auto") == "halo (contiguous boundaries)"
        rel_b = _rel(gather_output(plan_b, plan_b(xb)), spmm_scipy(csr_b, xb))
        assert rel_b < 1e-5, rel_b
        lines.append(f"dryrun_balanced_halo: mesh=({n_row},) rel={rel_b:.1e} ok")

    lines.append(_dryrun_realistic(mesh, shape, device, realistic_block_rows))
    return lines


def _dryrun_realistic(mesh, shape, device, block_rows_per_stripe: int) -> str:
    """b = 128 and block_rows_per_stripe block-rows a stripe (768: 98,304
    rows, the deployment shape of BASELINE.md), banded (blocks at (r, r)
    and (r, r + 1), the reordered shape halo serves), one halo training
    step."""
    from spmm_denseblock_tpu_torch.formats.bsr import BSR
    from spmm_denseblock_tpu_torch.parallel.train import make_dist_train_step

    b = 128
    nbr = shape[0] * block_rows_per_stripe
    rows = np.repeat(np.arange(nbr, dtype=np.int32), 2)
    cols = np.stack([np.arange(nbr, dtype=np.int32),
                     np.minimum(np.arange(nbr, dtype=np.int32) + 1, nbr - 1)], 1).reshape(-1)
    rng = np.random.default_rng(0)
    blocks = rng.standard_normal((nbr * 2, b, b)).astype(np.float32) * 0.02
    bsr = BSR.from_parts(rows, cols, blocks, (nbr * b, nbr * b), b)
    dims = [16, 32, 8]
    n = nbr * b
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    y = rng.integers(0, dims[-1], size=n).astype(np.int32)
    mask = np.ones(n, dtype=np.float32)
    params, opt_state, step = make_dist_train_step(bsr, mesh, dims, model="gcn",
                                                   block_size=b, strategy="halo",
                                                   device=device)
    params, opt_state, metrics = step(params, opt_state, x, y, mask)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss
    return (f"dryrun_realistic: mesh={shape} b={b} rows/stripe="
            f"{block_rows_per_stripe * b} nnzb={bsr.nnzb} loss={loss:.4f} ok")


def dryrun_multichip(n_devices: int, device=None, realistic_block_rows: int = 768) -> list:
    """Every pass of the JAX package's dry run in a world of n_devices
    ranks on an (n/2, 2) mesh (n even and >= 4; else (n, 1)), then its
    last pass, the readiness harness at JAX's minimal combination (halo,
    f32, 64 block-rows of 16, dim 32, worlds of 1 and min(4, n) ranks; its
    records to a temporary file); prints and returns rank 0's lines and
    the harness's. Every rank checks every pass; a failed one raises, as
    does a failed combination of the harness. device None: the card (one
    GPU a rank over NCCL where there are enough, else every rank on the
    one GPU over gloo; RuntimeError without a GPU); "cpu": CPU ranks over
    gloo. realistic_block_rows: the realistic pass's block-rows a stripe
    (768, JAX's)."""
    import tempfile
    from pathlib import Path

    from spmm_denseblock_tpu_torch.bench import readiness
    from spmm_denseblock_tpu_torch.ops._device import resolve_device
    from spmm_denseblock_tpu_torch.parallel.world import backend_for, run_world

    dev = resolve_device(device)
    lines = run_world(_dryrun_rank, n_devices, backend=backend_for(dev, n_devices),
                      args=(dev.type, realistic_block_rows), timeout_s=900.0,
                      threads=2)[0]
    for line in lines:
        print(line)
    with tempfile.TemporaryDirectory(prefix="sdb_readiness_") as tmp:
        readiness.main([
            "--devices", f"1,{min(4, n_devices)}", "--strategies", "halo",
            "--dtypes", "f32", "--n-block-rows", "64", "--block-size", "16",
            "--dim", "32", "--out", str(Path(tmp) / "readiness_dryrun.jsonl"),
            "--device", dev.type,
        ])
    lines.append(f"dryrun_readiness_harness: mesh={_mesh_shape(n_devices)} ok")
    print(lines[-1])
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the plan and weights live (default: the card)")
    ap.add_argument("--dryrun", type=int, default=None, metavar="N",
                    help="then dryrun_multichip(N) on the same device")
    args = ap.parse_args(argv)
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    print("entry:", tuple(out.shape), float(out.abs().mean()))
    if args.dryrun:
        dryrun_multichip(args.dryrun, args.device)


if __name__ == "__main__":
    main()
