"""Time the BSR kernels of chip_smoke.py's reorder phase, built from the
checkout at ROOT (default: this one), on one NVIDIA GPU:

    python3 scripts/torch_reorder_bsr_times.py [ROOT]

The ogbn-arxiv stand-in at its published size (169,343 nodes), under
gorder (the ordering with the fewest 32 x 32 blocks), F = 128, X of
seeded standard-normal values: f32 K2 at b = 32 and 16, f32 K1
(depth_sort=False) at b = 32, bf16 K2 and K3 (precision="high", sorted) at
b = 32 and 16, and at b = 32 bf16 K1 (resident=False), bf16 K4
(depth_sort=False) and K3 on K1's layout (precision="high",
depth_sort=False), then int8 K7 (dtype=torch.int8) and K6
(resident=False) at b = 32 and 16. One line per plan: the kernel's ms
(CUDA events, 10 calls after 2 warm-ups; K3 with its operand split; int8
the kernel alone on an operand quantized beforehand in the layout
ROOT's kernel reads, the whole call and the plain version beside it),
its slots, and the sha256 of its answer's bytes. Each plan is
freed after its line. Run it once per checkout, each in its own process
(the two packages share a name), in the order parent, change, change,
parent within one call: the times compare two builds on one card, and
equal digests mean answers equal bit for bit.
"""

from __future__ import annotations

import hashlib
import importlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PLANS = (("f32 K2", 32, {}), ("f32 K2", 16, {}),
         ("f32 K1", 32, {"depth_sort": False}),
         ("bf16 K2", 32, {"dtype": torch.bfloat16}),
         ("K3 sorted", 32, {"precision": "high"}),
         ("bf16 K2", 16, {"dtype": torch.bfloat16}),
         ("K3 sorted", 16, {"precision": "high"}),
         ("bf16 K1", 32, {"dtype": torch.bfloat16, "resident": False}),
         ("bf16 K4", 32, {"dtype": torch.bfloat16, "depth_sort": False}),
         ("K3 flat", 32, {"precision": "high", "depth_sort": False}),
         ("int8 K7", 32, {"dtype": torch.int8}),
         ("int8 K7", 16, {"dtype": torch.int8}),
         ("int8 K6", 32, {"dtype": torch.int8, "resident": False}),
         ("int8 K6", 16, {"dtype": torch.int8, "resident": False}))


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).parents[1])
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(root.resolve()))
    import chip_smoke as cs  # noqa: E402  (ROOT's, with ROOT's package)
    TI = importlib.import_module("spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas_int8")

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    cs._kernels.load()
    csr = cs.load_dataset("ogbn-arxiv", cache_dir=str(root / "build" / "datasets"),
                          scale=1.0, seed=cs.SEED)
    csr = cs.permutate(cs.STRATEGIES["gorder"](csr), csr)
    x = torch.as_tensor(np.random.default_rng(cs.SEED + 12).standard_normal(
        (csr.n_cols, 128)).astype(np.float32), device="cuda")
    for label, b, kw in PLANS:
        t0 = time.perf_counter()
        bsr = cs.csr_to_bsr(csr, b)
        plan = cs.spmm_plan(bsr, impl="bsr_pallas", block_size=b, grad=False,
                            device="cuda", **kw)
        host_s = time.perf_counter() - t0
        int8 = kw.get("dtype") is torch.int8
        xk = x.to(torch.bfloat16) if "dtype" in kw and not int8 else x
        extra = ""
        if int8:  # the kernel alone, then the whole call
            transposed = getattr(TI, "reads_transposed", lambda b: True)(b)
            q, c = TI.quantize_operand(plan, x, transposed=transposed)
            run = ((lambda: TI.run_quantized(plan, None, c, qdense_t=q)) if transposed
                   else (lambda: TI.run_quantized(plan, q, c)))
            ms = cs.cuda_ms(run, iters=10)
            plain = cs.cuda_ms(lambda: TI.run_quantized(plan, q.t() if transposed else q,
                                                        c, plain=True), iters=2)
            extra = (f" (whole call {cs.cuda_ms(lambda: plan(x), iters=10):.4f} ms, "
                     f"plain {plain:.3f} ms)")
        else:
            ms = cs.cuda_ms(lambda: plan(xk), iters=10)
        digest = hashlib.sha256(plan(xk).cpu().numpy().tobytes()).hexdigest()
        # a "high" plan holds its blocks as two bf16 planes of S*b rows
        n_slots = plan.arrays[2].shape[0] // (2 * b if "precision" in kw else 1)
        print(f"[{root.name}] {label:<9} b={b:<3} {cs.kernel_of(plan)[1]:<26} "
              f"{ms:.4f} ms{extra}, {n_slots} slots, plan {host_s:.1f} s (host), "
              f"sha256={digest} [{card}]", flush=True)
        del plan
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
