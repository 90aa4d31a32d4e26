"""Time how long a world of ranks takes to start on one NVIDIA GPU:
parallel.world.run_world with multiprocessing's "spawn" start method
against its fork server (the start method run_world uses; the server
preloads world.PRELOAD), worlds of 4 gloo ranks sharing the card, with
chip_smoke.py as the main module that every rank imports.

    python3 scripts/torch_world_startup.py

Prints, for each world, the seconds each rank took from the parent's call
to the first line of its function (to_fn) and to make its CUDA context
(cuda_init), and the world's total: spawn twice, then the fork server
three times (its first world also starts the server).
"""

from __future__ import annotations

import multiprocessing as mp
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402,F401 - the main module the ranks import
import torch  # noqa: E402
from spmm_denseblock_tpu_torch.parallel import world  # noqa: E402


def first_line(rank: int, n: int, t0: float) -> tuple:
    t1 = time.time()
    torch.ones(1, device="cuda").sum().item()
    return t1 - t0, time.time() - t1


class _Spawn:
    """Stands in for the multiprocessing module in world: every context is
    "spawn"."""

    @staticmethod
    def get_context(method):
        return _SpawnContext()


class _SpawnContext:
    def __init__(self):
        self._ctx = mp.get_context("spawn")

    def set_forkserver_preload(self, modules):
        pass

    def __getattr__(self, name):
        return getattr(self._ctx, name)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_world_startup: needs an NVIDIA GPU")
    for label, shim in (("spawn", _Spawn), ("spawn", _Spawn), ("fork server", mp),
                        ("fork server", mp), ("fork server", mp)):
        world.mp = shim
        t0 = time.time()
        r = world.run_world(first_line, 4, backend="gloo", args=(time.time(),), threads=2)
        print(f"{label} world of 4: to_fn {[round(a, 2) for a, _ in r]} cuda_init "
              f"{[round(b, 2) for _, b in r]} total {time.time() - t0:.2f} s", flush=True)


if __name__ == "__main__":
    main()
