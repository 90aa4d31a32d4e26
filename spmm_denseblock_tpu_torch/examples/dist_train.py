"""Distributed GNN training example (twin of ``examples/dist_train.py``):
a world of ranks on one machine, or one rank of a multi-machine run.

One machine (spawns --ranks processes; on the card they share it over
gloo unless each has a GPU, then NCCL):

    python -m spmm_denseblock_tpu_torch.examples.dist_train --ranks 4 --epochs 10
    python -m spmm_denseblock_tpu_torch.examples.dist_train --ranks 4 --device cpu

Several machines (every process runs the SAME command under torchrun,
whose environment names the world; NCCL, one GPU a rank):

    torchrun --nnodes 2 --nproc-per-node 8 ... -m \\
        spmm_denseblock_tpu_torch.examples.dist_train --multihost --epochs 50

The mesh is ("row", "col"): graph-node stripes with their exchange over
"row", the features and the weights' output dims over "col"
(parallel/train.py). --ckpt-dir keeps sharded checkpoints
(models/checkpoint_dist.py): a run resumes from the latest step there and
saves every --ckpt-every epochs.
"""

from __future__ import annotations

import argparse
import time


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4,
                    help="ranks to spawn on this machine (not with --multihost)")
    ap.add_argument("--multihost", action="store_true",
                    help="this process is one rank of a torchrun world")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the ranks run (default: the card)")
    ap.add_argument("--n-nodes", type=int, default=2048)
    ap.add_argument("--dims", type=int, nargs="*", default=[32, 64, 8])
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--strategy", default="ring", choices=["ring", "allgather"])
    ap.add_argument("--col-parallel", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None,
                    help="sharded checkpoints: resume from the latest step if one "
                         "exists, save every --ckpt-every epochs")
    ap.add_argument("--ckpt-every", type=int, default=10)
    return ap


def run(args) -> dict:
    """The training on this rank (torch.distributed initialized): rank 0
    logs; returns {"start", "losses", "ms_per_epoch"}."""
    import torch
    import torch.distributed as dist

    from spmm_denseblock_tpu_torch.parallel import make_mesh, pod_mesh
    from spmm_denseblock_tpu_torch.parallel.train import make_dist_train_step, random_problem

    device_type = "cpu" if args.device == "cpu" else "cuda"
    if device_type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    n = dist.get_world_size()
    if args.multihost:
        rows = args.col_parallel and n // args.col_parallel
        mesh = pod_mesh(row_parallelism=rows, device_type=device_type)
    else:
        col = args.col_parallel or (2 if n >= 4 and n % 2 == 0 else 1)
        mesh = make_mesh((n // col, col), device_type=device_type)
    log = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    log(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} over {n} ranks "
        f"({dist.get_backend()}, {device_type})", flush=True)

    adj, x, y, mask = random_problem(args.n_nodes, args.dims, p=0.02, seed=0)
    params, opt_state, step = make_dist_train_step(
        adj, mesh, args.dims, model="gcn", block_size=args.block_size,
        strategy=args.strategy, device="cpu" if device_type == "cpu" else None)

    mgr, start = None, 0
    if args.ckpt_dir:
        from spmm_denseblock_tpu_torch.models import (
            make_manager,
            restore_dist_checkpoint,
            save_dist_checkpoint,
        )

        mgr = make_manager(args.ckpt_dir)
        if mgr.latest_step() is not None:
            _, start = restore_dist_checkpoint(mgr, step.state(params, opt_state))
            log(f"resumed from {args.ckpt_dir} at epoch {start}", flush=True)

    losses = []
    t0 = time.perf_counter()
    for epoch in range(start, args.epochs):
        params, opt_state, m = step(params, opt_state, x, y, mask)
        losses.append(float(m["loss"]))
        if epoch % 5 == 0 or epoch == args.epochs - 1:
            log(f"epoch {epoch:3d} loss {losses[-1]:.4f} acc {float(m['acc']):.3f}",
                flush=True)
        if mgr and (epoch + 1) % args.ckpt_every == 0:
            save_dist_checkpoint(mgr, epoch + 1, step.state(params, opt_state))
    dt = time.perf_counter() - t0
    done = args.epochs - start
    if done:
        log(f"{done} epochs in {dt:.1f}s ({dt / done * 1e3:.0f} ms/epoch)", flush=True)
    return {"start": start, "losses": losses,
            "ms_per_epoch": dt / done * 1e3 if done else None}


def _rank(rank: int, n: int, args) -> dict:
    return run(args)


def main(argv=None) -> dict:
    """Returns rank 0's record of run() (this process's with --multihost)."""
    from spmm_denseblock_tpu_torch.ops._device import resolve_device
    from spmm_denseblock_tpu_torch.parallel.multihost import initialize
    from spmm_denseblock_tpu_torch.parallel.world import backend_for, run_world

    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)  # raises where there is no GPU
    if args.multihost:
        initialize(backend="gloo" if dev.type == "cpu" else "nccl")
        return run(args)
    return run_world(_rank, args.ranks, backend=backend_for(dev, args.ranks), args=(args,),
                     timeout_s=1800.0, threads=1 if dev.type == "cpu" else 2)[0]


if __name__ == "__main__":
    main()
