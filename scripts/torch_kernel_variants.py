"""Time variants of the port's BSR kernels against the source as it is,
at bench.py's op shape (random_bsr(2e-2, 1024, 1024, b=128, seed=1234),
F=512), on one NVIDIA GPU:

    python3 scripts/torch_kernel_variants.py f32_k2   # exact-f32 K2, K1, K4
    python3 scripts/torch_kernel_variants.py f32_small  # the same at b = 16, 32
    python3 scripts/torch_kernel_variants.py bf16_small  # bf16 K2, K3 at b = 16, 32
    python3 scripts/torch_kernel_variants.py int8_small  # int8 K7, K6 at b = 16, 32
    python3 scripts/torch_kernel_variants.py k3       # K3 (precision="high")
    python3 scripts/torch_kernel_variants.py int8     # int8 K7, K8 and the
                                                      # operand's quantization

Each variant is a kernel source (csrc/bsr_spmm.cu, or csrc/bsr_spmm_int8.cu
for int8) with a few lines replaced (VARIANTS), built beside the tree's
under tmp/variants/ and loaded in its place; the variants run in the
order A B .. B A on one card, so that drift shows as a spread of the
pairs. Every variant's answer is compared with the tree's bit for bit
(the K3 "hi*hi only" and the int8 "no products" variants drop products on
purpose: they time the loads, not an answer). For f32_k2 each run times
the three exact-f32 kernels that share the pipelined FFMA loop: K2 (the
default plan), K1 (depth_sort=False; K5 launches the same kernel) and K4
(chip_smoke.f32_rowgroup_plan), and K2 on the f32 GCN slice's SpMM
(chip_smoke's ddi stand-in, F=256, 64-column tiles). f32_small times the
pipelined loop's small instances on chip_smoke's reorder plans (the
ogbn-arxiv stand-in under gorder, F=128: K2 at b = 32 and 16, K1 at b =
32) and on K2 at b = 32 under rcmk and the original order (other hub
positions), each at the geometry's F tile width, at 32, 64 and 128
columns forced, and with the lane order switched off (packed order); its
source variants change the stages, the threads a CTA (so the microtiles)
and how the block chunk is staged. bf16_small does the same for the
small-block tensor-core loop: bf16 K2 (on the bf16 operand) and K3 sorted
(the whole call, its operand split included) at b = 32 and 16 on arxiv
under gorder and bf16 K2 at b = 32 under rcmk; its source variants change
the stages in flight and the operand rows' path (L1, or L2 only).
int8_small does the same for the small-block int8 tensor-core loop
(csrc/bsr_spmm_int8.cu): int8 K7 (group scale) at b = 32 and 16 and K6
(resident=False) at b = 32 under gorder, K7 at b = 32 under rcmk, each the
kernel alone on an operand quantized and transposed once; its source
variants change the stages in flight, the operand rows' path and where
a slot's column is read from. For K3 each
run times the whole call
(the operand split included) and the ring alone on an operand split once,
and bf16 K2 on the same build. For int8 each run times K7
(group scale, calibrated as bench.py's int8 tier) and K8 on the ring
alone, on an operand quantized and transposed once, and the operand's
quantization into the ring's layout (quantize_int8, dynamic and static
scales).
"""

from __future__ import annotations

import functools
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from spmm_denseblock_tpu_torch.formats.bsr import random_bsr  # noqa: E402
from spmm_denseblock_tpu_torch.ops import _kernels  # noqa: E402

T = importlib.import_module("spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas")
TI = importlib.import_module("spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas_int8")

PIPE_LOOP = "#pragma unroll\n    for (int kk = 0; kk < kPipeK; ++kk) {"
PIPE_OROW = """  // The output block-row, read after the loop so that it holds no
  // registers there: K2's from its window and position, K4's (and K1's
  // and K5's) the lane itself.
  const int64_t orow =
      win_ids != nullptr ? (int64_t)win_ids[j0] * window + pos[j0 * R + lane]
                         : lane_id;
"""
PIPE_STAGES = "static constexpr int kStages = kSmall ? 4 : BN == 128 ? 3 : 4;"
PIPE_J0 = "  const int64_t j0 = group_ptr[g];\n  const int n_chunks"
I8_STAGES = "static constexpr int kMaxStages = 6;"
# the small instances' block chunk staged untransposed: rows of the
# block's 16-deep chunk in 16-byte copies (rows of 20 floats), read a
# float4 of 4 depths a row at a time, in the same depth order
A_COPY_T = """    const float* blk = blocks + ls * (BM * BM) + lk * kPipeK + a_m * BM + a_k;
    const uint32_t a_st = smem + (uint32_t)(issued % kStages) *
                                     (G::kStageFloats * 4);
#pragma unroll
    for (int it = 0; it < BM / kARows; ++it)
      cp_async4(a_st + (a_k * G::kAStride + a_m + it * kARows) * 4,
                blk + it * kARows * BM);
"""
A_COPY_ROWS = """    const float* blk = blocks + ls * (BM * BM) + lk * kPipeK;
    const uint32_t a_st = smem + (uint32_t)(issued % kStages) *
                                     (G::kStageFloats * 4);
    for (int e = tid; e < BM * 4; e += kThreads)
      cp_async16(a_st + (e / 4 * (kPipeK + 4) + e % 4 * 4) * 4,
                 blk + e / 4 * BM + e % 4 * 4, true);
"""
A_READ_T = """    for (int kk = 0; kk < kPipeK; ++kk) {
      float a[TM], x[TN];
      const float* ap = as + kk * G::kAStride + ty * TM;
      if constexpr (TM % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(ap + i);
          a[i] = v.x, a[i + 1] = v.y, a[i + 2] = v.z, a[i + 3] = v.w;
        }
      } else if constexpr (TM == 2) {
        const float2 v = *reinterpret_cast<const float2*>(ap);
        a[0] = v.x, a[1] = v.y;
      } else {
        a[0] = *ap;
      }
"""
A_READ_ROWS = """    for (int kk = 0; kk < kPipeK; ++kk) {
      float a[TM], x[TN];
      if (kk % 4 == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
          av[i] = *reinterpret_cast<const float4*>(
              as + (ty * TM + i) * (kPipeK + 4) + kk);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = kk % 4 == 0 ? av[i].x : kk % 4 == 1 ? av[i].y
             : kk % 4 == 2 ? av[i].z : av[i].w;
"""
# which of _kernels.SOURCES each group of variants edits
SOURCE = {"f32_k2": 0, "f32_small": 0, "bf16_small": 0, "k3": 0, "int8": 1,
          "int8_small": 1}
I8_SMALL_STAGES = "kFitStages < 3 ? 3 : kFitStages > 16 ? 16 : kFitStages;"
I8_SMALL_X_COPY = "cp_async16_ca(sa + G::kABytes + r * G::kRow + c,"
I8_SMALL_COL = "load_next(*reinterpret_cast<const int32_t*>(header + 4));"
MMA_STAGES = "static constexpr int kStages = kFit < 3 ? 3 : kFit > 8 ? 8 : kFit;"
MMA_X_COPY = "cp_async16_ca(st + P * G::kABytes + p * G::kXBytes + r * G::kXRow + c * 2,"
VARIANTS = {
    "f32_k2": {
        "1 CTA an SM": {"static constexpr int kMinBlocks = 512 / kThreads;":
                        "static constexpr int kMinBlocks = kSmall ? 512 / kThreads : 1;"},
        "depth loop unrolled by 4": {PIPE_LOOP: PIPE_LOOP.replace("unroll", "unroll 4")},
        "4 stages at every BN": {PIPE_STAGES: PIPE_STAGES.replace("? 3 : 4", "? 4 : 4")},
        "3 stages at every BN": {PIPE_STAGES: PIPE_STAGES.replace("? 3 : 4", "? 3 : 3")},
        "output row before the loop": {
            PIPE_OROW: "",
            PIPE_J0: PIPE_J0.replace("\n", "\n" + PIPE_OROW.split("\n", 3)[3])},
    },
    "f32_small": {
        "3 stages": {PIPE_STAGES: PIPE_STAGES.replace("? 4 :", "? 3 :")},
        "6 stages": {PIPE_STAGES: PIPE_STAGES.replace("? 4 :", "? 6 :")},
        # half the outputs a thread at b = 16 (1 x 4 at BN = 32)
        "128 threads at b = 16": {"kThreads = kSmall ? 4 * BM : 256;":
                                  "kThreads = kSmall ? 128 : 256;"},
        # twice the outputs a thread at b = 32 (8 x 8 at BN = 128)
        "64 threads at b = 32": {"kThreads = kSmall ? 4 * BM : 256;":
                                 "kThreads = kSmall ? 64 : 256;"},
        "block chunk untransposed, 16-byte copies": {
            "static constexpr int kAFloats = kPipeK * kAStride;":
            "static constexpr int kAFloats = BM * (kPipeK + 4);",
            A_COPY_T: A_COPY_ROWS,
            "#pragma unroll\n" + A_READ_T: "float4 av[TM];\n#pragma unroll\n" + A_READ_ROWS},
    },
    "bf16_small": {
        "96 KiB of stages, up to 12": {
            "kFit = 49152 / kStageBytes;": "kFit = 98304 / kStageBytes;",
            MMA_STAGES: MMA_STAGES.replace("kFit > 8 ? 8", "kFit > 12 ? 12")},
        "operand rows through L2 only (.cg)": {
            MMA_X_COPY: MMA_X_COPY.replace("cp_async16_ca(", "cp_async16(")},
    },
    "int8_small": {
        "at most 8 stages": {
            I8_SMALL_STAGES: I8_SMALL_STAGES.replace("> 16 ? 16", "> 8 ? 8")},
        "96 KiB of stages, up to 32": {
            "kFitStages = 49152 / kStageBytes;": "kFitStages = 98304 / kStageBytes;",
            I8_SMALL_STAGES: I8_SMALL_STAGES.replace("> 16 ? 16", "> 32 ? 32")},
        "operand rows through L2 only (.cg)": {
            I8_SMALL_X_COPY: I8_SMALL_X_COPY.replace("cp_async16_ca(", "cp_async16(")},
        "column read from global when its copies issue": {
            I8_SMALL_COL: "load_next(__ldg(slot_cols + lw.slot));"},
    },
    "k3": {
        "ring of 2 stages": {
            "static constexpr int kStages = kFit < 4 ? kFit : 4;":
            "static constexpr int kStages = kFit < 2 ? kFit : 2;"},
        "hi*hi chain only": {"constexpr int kChains = P == 1 ? 1 : 3;":
                             "constexpr int kChains = 1;"},
    },
    "int8": {
        "ring of 4 stages": {I8_STAGES: I8_STAGES.replace("6", "4")},
        "as many stages as fit": {I8_STAGES: I8_STAGES.replace("6", "16")},
        "no products": {"for (int k = 0; k < BM / 32; ++k)\n        WgmmaS8":
                        "for (int k = 0; k < 0; ++k)\n        WgmmaS8"},
        # the quantization as it was before a NaN quotient became 0, and
        # with the NaN made 0 by a test beside the float clamp
        "float clamp, no NaN test": {
            "const int t = min(max(__float2int_rn(v / s), -127), 127);":
            "const int t = (int)fminf(fmaxf(rintf(v / s), -127.f), 127.f);"},
        "float clamp and a NaN test": {
            "const int t = min(max(__float2int_rn(v / s), -127), 127);":
            "const float r = v / s;\n  const int t = (int)(isnan(r) ? 0.f : "
            "fminf(fmaxf(rintf(r), -127.f), 127.f));"},
    },
}


def build_variants(which: str) -> dict:
    """{name: SOURCES tuple}, "as is" first."""
    i = SOURCE[which]
    src = _kernels.SOURCES[i]
    text = src.read_text()
    out = {"as is": _kernels.SOURCES}
    for name, subs in VARIANTS[which].items():
        t = text
        for old, new in subs.items():
            if old not in t:
                raise SystemExit(f"variant {name!r}: {old!r} is not in {src.name}")
            t = t.replace(old, new)
        path = ROOT / "tmp" / "variants" / name.replace(" ", "_").replace("*", "x") / src.name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(t)
        sources = list(_kernels.SOURCES)
        sources[i] = path
        out[name] = tuple(sources)
    return out


def use(sources) -> None:
    _kernels.SOURCES = sources
    _kernels._libs = None
    _kernels.load()


def cuda_ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    which = sys.argv[1] if len(sys.argv) > 1 else ""
    if which not in VARIANTS or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    bsr = random_bsr(2e-2, 1024, 1024, block_size=128, seed=1234)
    x = torch.as_tensor(np.random.default_rng(1234).standard_normal(
        (bsr.shape[1], 512)).astype(np.float32), device="cuda")
    sources = build_variants(which)
    use(sources["as is"])
    if which == "int8":
        return time_int8(bsr, x, sources, card)
    if which == "f32_k2":
        return time_f32(bsr, x, sources, card)
    if which in SMALL_RUNS:
        return time_small(which, sources, card)
    plan = T.bsr_spmm_pallas_plan(bsr, grad=False, device="cuda", precision="high")
    bf16 = T.bsr_spmm_pallas_plan(bsr, grad=False, dtype=torch.bfloat16, device="cuda")
    x_bf = x.to(torch.bfloat16)
    ref = plan(x)
    xp, split = T.split_operand(x), T.split_operand
    names = list(sources)
    for name in names + names[::-1]:
        use(sources[name])
        line = f"[{which}] {name:<26} whole call {cuda_ms(lambda: plan(x)):.3f} ms"
        T.split_operand = lambda d: xp  # the ring alone
        line += f", ring alone {cuda_ms(lambda: plan(x)):.3f} ms"
        same = torch.equal(plan(x), ref)
        T.split_operand = split
        line += f", bf16 K2 {cuda_ms(lambda: bf16(x_bf)):.3f} ms"
        print(f"{line}, answer equal to the tree's: {same} [{card}]", flush=True)
    return 0


def time_f32(bsr, x, sources, card: str) -> int:
    """Exact-f32 K2, K1 and K4 (the pipelined FFMA loop's walks) at the op
    shape (BN = 128), and K2 on the f32 slice's SpMM (the ddi stand-in,
    F = 256: BN = 64, 136 CTAs), each variant in the order A B .. B A."""
    from chip_smoke import ROOT, ddi_adjacency, f32_rowgroup_plan, seeded
    from spmm_denseblock_tpu_torch.ops import spmm_plan

    adj = ddi_adjacency(ROOT / "build" / "datasets")
    x_ddi = torch.as_tensor(seeded((adj.n_rows, 256), 1234), device="cuda")
    runs = {"K2": (T.bsr_spmm_pallas_plan(bsr, grad=False, device="cuda"), x),
            "K1": (T.bsr_spmm_pallas_plan(bsr, grad=False, depth_sort=False,
                                          device="cuda"), x),
            "K4": (f32_rowgroup_plan(bsr), x),
            "K2 ddi": (spmm_plan(adj, impl="bsr_pallas", block_size=128,
                                 grad=False, device="cuda"), x_ddi)}
    refs = {k: p(xk) for k, (p, xk) in runs.items()}
    names = list(sources)
    for name in names + names[::-1]:
        use(sources[name])
        line = f"[f32_k2] {name:<26}"
        for k, (p, xk) in runs.items():
            iters = 100 if k.endswith("ddi") else 10
            line += (f" {k} {cuda_ms(lambda: p(xk), iters):.3f} ms (equal: "
                     f"{torch.equal(p(xk), refs[k])})")
        print(f"{line} [{card}]", flush=True)
    return 0


# the reorder phase's plans each small-block sweep times: (ordering,
# label, block size, plan arguments)
SMALL_RUNS = {
    "f32_small": (("gorder", "K2", 32, {}), ("gorder", "K2", 16, {}),
                  ("gorder", "K1", 32, {"depth_sort": False}),
                  ("rcmk", "K2", 32, {}), ("original", "K2", 32, {})),
    "bf16_small": (("gorder", "bf16 K2", 32, {"dtype": torch.bfloat16}),
                   ("gorder", "K3", 32, {"precision": "high"}),
                   ("gorder", "bf16 K2", 16, {"dtype": torch.bfloat16}),
                   ("gorder", "K3", 16, {"precision": "high"}),
                   ("rcmk", "bf16 K2", 32, {"dtype": torch.bfloat16})),
    "int8_small": (("gorder", "int8 K7", 32, {"dtype": torch.int8}),
                   ("gorder", "int8 K7", 16, {"dtype": torch.int8}),
                   ("gorder", "int8 K6", 32, {"dtype": torch.int8, "resident": False}),
                   ("rcmk", "int8 K7", 32, {"dtype": torch.int8})),
}
# the module and geometry each sweep's entries take their F tile width
# from: (bn, ld) for f32 and bf16, bn alone for int8
SMALL_GEOMETRY = {"f32_small": (T, "f32_small_geometry"),
                  "bf16_small": (T, "bf16_small_geometry"),
                  "int8_small": (TI, "int8_small_geometry")}


def _bn_of(geometry_result) -> int:
    return geometry_result if isinstance(geometry_result, int) else geometry_result[0]


def time_small(which: str, sources, card: str) -> int:
    """The small-block instances (the pipelined loop's for f32_small, the
    tensor-core loop's for bf16_small, the int8 one's for int8_small, on
    an operand quantized and transposed once) on chip_smoke's reorder
    dataset, the arxiv stand-in (F = 128), SMALL_RUNS's plans, each
    variant in the order A B .. B A; per plan the geometry's BN, BN = 32,
    64 and 128 forced, and the geometry's BN in packed lane order."""
    import chip_smoke as cs

    src = cs.load_dataset(cs.REORDER_DATASET, cache_dir=str(ROOT / "build" / "datasets"),
                          scale=cs.REORDER_SCALE, seed=cs.SEED)
    x = torch.as_tensor(cs.seeded((src.n_cols, cs.REORDER_F), cs.SEED + 12),
                        device="cuda")
    module, attr = SMALL_GEOMETRY[which]
    geometry = getattr(module, attr)
    plans, runs, orders = {}, {}, {}
    for name, kid, b, kw in SMALL_RUNS[which]:
        if name not in orders:
            orders[name] = cs.permutate(cs.STRATEGIES[name](src), src)
        plan = cs.spmm_plan(cs.csr_to_bsr(orders[name], b), impl="bsr_pallas",
                            block_size=b, grad=False, device="cuda", **kw)
        int8 = kw.get("dtype") is torch.int8
        # the lane order: the last array, or before an int8 plan's
        # static scales (none here)
        order, depth, n_slots = plan.arrays[-1], plan.statics[6], cs.plan_slots(plan)
        key = f"{name} {kid} b={b}"
        plans[key] = plan
        if int8:
            qt, c = TI.quantize_operand(plan, x, transposed=True)
            runs[key] = functools.partial(TI.run_quantized, plan, None, c, qdense_t=qt)
        else:
            runs[key] = functools.partial(plan, x.to(torch.bfloat16) if "dtype" in kw
                                          else x)
        # where packed order would start the deepest lane
        print(f"[{which}] {key}: {n_slots} slots, deepest lane {depth} slots, at "
              f"{order[0].item()} of {order.numel()} lanes in packed order, BN="
              f"{_bn_of(geometry(b, cs.REORDER_F, T._sm_count(0), n_slots, depth))}",
              flush=True)
    refs = {k: run() for k, run in runs.items()}

    def packed_order(plan):  # the lanes in packed order
        last = f"a{len(plan.arrays) - 1}"
        saved = getattr(plan, last)
        setattr(plan, last, torch.arange(saved.numel(), dtype=torch.int32,
                                         device=saved.device))
        return lambda: setattr(plan, last, saved)

    names = list(sources)
    for name in names + names[::-1]:
        use(sources[name])
        for k, p in plans.items():
            run = runs[k]
            # the geometry's BN in lane order, then in packed order, next to
            # each other, so that drift over the sweep stays out of the pair
            line = (f"[{which}] {name:<40} {k:<16}: BN=auto "
                    f"{cuda_ms(run):.3f} ms ({torch.equal(run(), refs[k])})")
            restore = packed_order(p)
            line += (f", packed order {cuda_ms(run):.3f} ms"
                     f" ({torch.equal(run(), refs[k])});")
            restore()
            for bn in (32, 64, 128):
                def forced(b, F, n_sms, n_slots, depth, bn=bn):
                    got = geometry(b, F, n_sms, n_slots, depth)
                    return bn if isinstance(got, int) else (bn, got[1])
                setattr(module, attr, forced)
                line += (f" BN={bn} {cuda_ms(run):.3f} ms"
                         f" ({torch.equal(run(), refs[k])})")
                setattr(module, attr, geometry)
            print(f"{line} [{card}]", flush=True)
    return 0


def _equal(a, b) -> bool:
    """Tensors, or tuples of them (quantize_int8's (q, scales)), equal."""
    if isinstance(a, tuple):
        return all(torch.equal(u, v) for u, v in zip(a, b))
    return torch.equal(a, b)


def time_int8(bsr, x, sources, card: str) -> int:
    """K7 (group scale) and K8 on the ring alone, on an operand quantized
    and transposed once, and quantize_int8 into that layout with dynamic
    and static scales; each variant in the order A B .. B A."""
    cal = x[:4096]
    runs = {}
    for layout, kw in (("K7", {}), ("K8", {"depth_sort": False})):
        plan = TI.bsr_spmm_pallas_int8_plan(bsr, calibration=cal, device="cuda", **kw)
        qt, cs = TI.quantize_operand(plan, x, transposed=True)
        runs[layout] = functools.partial(TI.run_quantized, plan, None, cs, qdense_t=qt)
    n_out = runs["K7"].args[0].statics[4]
    runs["quantize dynamic"] = functools.partial(TI.quantize_int8, x, n_out, None, True)
    runs["quantize static"] = functools.partial(TI.quantize_int8, x, n_out, cs, True)
    refs = {k: run() for k, run in runs.items()}
    names = list(sources)
    for name in names + names[::-1]:
        use(sources[name])
        line = f"[int8] {name:<26}"
        for k, run in runs.items():
            what = "" if k.startswith("quantize") else " ring alone"
            line += (f" {k}{what} {cuda_ms(run):.3f} ms (answer equal to the "
                     f"tree's: {_equal(run(), refs[k])})")
        print(f"{line} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
