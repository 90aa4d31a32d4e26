"""Start a world of ranks on this machine and collect what each returns.

``run_world(fn, n)`` starts n processes, initializes
``torch.distributed`` in each over a file store in a fresh directory,
calls ``fn(rank, n, *args)`` and returns the n results in rank order.
The ranks fork from multiprocessing's fork server, a fresh interpreter
that imports torch, the parallel package and the main module once
(PRELOAD) and never touches CUDA: no rank inherits the parent's CUDA
state, and a world does not wait for each rank to import torch, as it
did under the "spawn" start method (scripts/torch_world_startup.py
times the two). The server copies the environment once, when the first
world starts: every later rank inherits that copy, so a variable the
parent sets or changes after its first world (an NCCL_* or SDB_* knob)
does not reach the ranks; pass such a value through `args` instead.
The world has a deadline: the process group's own timeout, and a join
that kills every rank still running and raises. A rank that raises
fails the world with its traceback; none is reported as a pass.

`fn` must be importable by name in a fresh interpreter (a module-level
function of a module whose import does not start work). The results
travel as pickles through files in the world's directory.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Callable, List, Optional

import torch
import torch.distributed as dist


# what the fork server imports before it forks a rank
PRELOAD = ["__main__", "torch", "spmm_denseblock_tpu_torch.parallel"]


def _child(fn, rank: int, n: int, backend: Optional[str], root: str, args: tuple,
           threads: Optional[int], timeout_s: float) -> None:
    out = Path(root) / f"rank{rank}.pkl"
    try:
        if threads:
            torch.set_num_threads(threads)
        if backend is None:  # fn initializes torch.distributed itself
            result = ("ok", fn(rank, n, *args))
        else:
            if backend == "nccl":
                torch.cuda.set_device(rank % torch.cuda.device_count())
            dist.init_process_group(backend, init_method=f"file://{root}/store",
                                    world_size=n, rank=rank,
                                    timeout=timedelta(seconds=timeout_s))
            try:
                result = ("ok", fn(rank, n, *args))
            finally:
                dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - every failure goes to the parent
        result = ("error", traceback.format_exc())
        (Path(root) / f"rank{rank}.failed").touch()
    tmp = out.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(result, f)
    os.replace(tmp, out)


def _failed(root: str, rank: int) -> bool:
    return (Path(root) / f"rank{rank}.failed").exists()


def backend_for(device: torch.device, n: int) -> str:
    """NCCL where each of n ranks can have a GPU of its own, else gloo
    (CPU ranks, or ranks sharing a GPU)."""
    return "nccl" if device.type == "cuda" and torch.cuda.device_count() >= n else "gloo"


def run_world(fn: Callable, n: int, backend: Optional[str] = "gloo", args: tuple = (),
              timeout_s: float = 300.0, threads: Optional[int] = 1,
              root: Optional[str] = None) -> List:
    """fn(rank, n, *args) on each of n ranks; returns the results
    in rank order. backend None leaves torch.distributed to fn. Raises RuntimeError with every failed rank's traceback,
    or when the world outlives timeout_s (its ranks are killed)."""
    made = root is None
    root = tempfile.mkdtemp(prefix="sdb_world_") if made else root
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)  # read when the server starts
    procs = [ctx.Process(target=_child, args=(fn, r, n, backend, root, args,
                                              threads, timeout_s), daemon=True)
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        # a rank that failed leaves the others waiting in a collective
        # until the group's timeout: give them a grace period, then stop
        deadline = time.monotonic() + timeout_s + 30.0
        failed_at = None
        while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
            if failed_at is None and any(
                    p.exitcode not in (None, 0) or _failed(root, r)
                    for r, p in enumerate(procs)):
                failed_at = time.monotonic()
            if failed_at is not None and time.monotonic() - failed_at > 10.0:
                break
            time.sleep(0.05)
        late = ([] if failed_at is not None else
                [r for r, p in enumerate(procs) if p.is_alive()])
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10.0)
        if late:
            raise RuntimeError(f"ranks {late} of a world of {n} ran past "
                               f"{timeout_s:.0f} s and were killed")
        results, errors = [], []
        for r, p in enumerate(procs):
            path = Path(root) / f"rank{r}.pkl"
            if not path.exists():
                errors.append(f"rank {r}: exited with code {p.exitcode} and no result")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                errors.append(f"rank {r}:\n{value}")
            results.append(value)
        if errors:
            raise RuntimeError("a world's ranks failed:\n" + "\n".join(errors))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        if made:
            shutil.rmtree(root, ignore_errors=True)
