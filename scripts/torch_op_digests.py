"""Print a digest of each exact-f32 kernel's answer at bench.py's op shape
(random_bsr(2e-2, 1024, 1024, b=128, seed=1234), F=512, X from
default_rng(1234)) and, at b = 16 and 32, on a small seeded BSR with one
deep row (deep_row_bsr: 64 block-rows over 600 block-columns, block-row 20
holding a block in every column, the others 6 to 12; F=96), and of each
int8 kernel's answer on that deep-row BSR, built from the checkout at ROOT
(default: this one), on one NVIDIA GPU:

    python3 scripts/torch_op_digests.py [ROOT]

One line per kernel and shape, with the sha256 of the answer's bytes:
f32 K2 (the default plan), K1 (depth_sort=False), K5 (resident=True,
depth_sort=False) and K4 (chip_smoke.f32_rowgroup_plan: no plan routes f32
to row groups); int8 K7 (the default plan, group scale), K7 with per-slot
scales (group_scale=False), K8 (depth_sort=False), K6 (resident=False) and
K9 (resident=True, f_tile=128), each the whole call on the f32 X (dynamic
quantization). Run it once per checkout, each in its own process (the two
packages share a name), and compare the lines: equal digests mean
answers equal bit for bit, which is what a redesign that keeps each
output's sum order (for int8, each output's f32 terms in walk order) must
give.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np
import torch


def deep_row_bsr(BSR, b: int, seed: int = 7):
    """64 block-rows over 600 block-columns: block-row 20 holds all 600
    blocks, block-row 5 none, the others 6 to 12 (over 8 a block-row on
    average, so the f32 plan sorts); standard-normal blocks."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(64):
        n = 600 if r == 20 else 0 if r == 5 else int(rng.integers(6, 13))
        rows += [r] * n
        cols += sorted(rng.choice(600, n, replace=False).tolist())
    blocks = rng.standard_normal((len(rows), b, b)).astype(np.float32)
    return BSR.from_parts(np.asarray(rows, np.int32), np.asarray(cols, np.int32),
                          blocks, (64 * b - 3, 600 * b - 5), b)


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).parents[1])
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(root.resolve()))
    import chip_smoke as cs  # noqa: E402  (ROOT's, with ROOT's package)

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [("b=128 op", cs.random_bsr(2e-2, 1024, 1024, block_size=128, seed=1234),
              512, 1234)]
    cases += [(f"b={b} deep row", deep_row_bsr(cs.BSR, b), 96, b) for b in (16, 32)]
    for tag, bsr, F, seed in cases:
        x = torch.as_tensor(np.random.default_rng(seed).standard_normal(
            (bsr.shape[1], F)).astype(np.float32), device="cuda")
        plan = lambda **kw: cs.bsr_spmm_pallas_plan(bsr, grad=False, device="cuda",
                                                    **kw)
        plans = [("K2 sorted", plan()), ("K1 flat", plan(depth_sort=False)),
                 ("K5 resident", plan(resident=True, depth_sort=False)),
                 ("K4 rowgroup", cs.f32_rowgroup_plan(bsr))]
        if bsr.b < 64:
            i8 = lambda **kw: cs.bsr_spmm_pallas_int8_plan(bsr, device="cuda", **kw)
            plans += [("int8 K7", i8()), ("int8 K7 slot", i8(group_scale=False)),
                      ("int8 K8", i8(depth_sort=False)), ("int8 K6", i8(resident=False)),
                      ("int8 K9", i8(resident=True, f_tile=128))]
        for label, p in plans:
            out = p(x).cpu().numpy()
            digest = hashlib.sha256(out.tobytes()).hexdigest()
            print(f"{tag:<15} {label:<12} {tuple(out.shape)} sha256={digest}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
