"""Time K10's one-bf16-pass kernel (sdb_csr_spmm_bf16, precision="default")
on one NVIDIA GPU against variants of its source, its strip counts, its
segment order and two designs of the operand's cast:

    python3 scripts/torch_csr_bf16_probe.py

Graphs, as chip_smoke.py's phase 8d builds them: ddi (the ogbl-ddi
stand-in under rcmk, sym_norm_adjacency, F = 256), the arxiv serve graph
(the ogbn-arxiv stand-in at its published size under gorder,
sym_norm_adjacency, F = 128), the same stand-in under each of chip_smoke's
four orderings (no normalization, F = 128) and the op csr shape
(random_csr(2e-3, 2^17, seed=1234), F = 512), X seeded normal f32.

1. Variants (VARIANTS): csrc/csr_spmm.cu with a few lines replaced, built
   beside the tree's under tmp/variants/ and loaded in its place: the rows
   of X in flight a lane, the threads a CTA and the CTAs an SM holds
   (which caps the registers), two 16-byte loads a lane (half the lanes a
   segment, twice the segments a warp), and the gathers cut to 64 rows of X
   (always cached: what is left is the walk's own cost; its answer
   differs, so it is not checked). Each is timed on ddi, the serve graph
   and the op csr shape as the whole call from the f32 operand and as the
   kernel alone on the bf16 operand, in the order A B .. B A, so drift
   shows as the spread of the pairs; every other variant's answer equals
   the tree's bit for bit (the sums are the same).
2. Strips and segment order on the serve graph and on arxiv under each
   ordering: 1 (W = 128; the bf16 X is 83% of the L2), 2 and 4 strips,
   forced through csr_bf16_strip_width, each with the plan's segments
   longest first (the tree's order for precision="default") and in row
   order (f32 K10's), in two passes of opposite order.
3. The cast at ddi and on the serve graph: the tree's design (a separate
   .to(torch.bfloat16) pass, then 16-byte bf16 gathers) against f32 rows
   rounded to bf16 inside the gather (cvt.rn.bf16x2.f32, round to nearest
   even as .to(torch.bfloat16): the same bits on finite values; no cast
   kernel), the second on strips sized for the f32 operand (the bf16 rule
   on half the L2). Beside them f32 K10 and bf16 cuSPARSE
   (torch.sparse_csr_tensor @ X on the bf16 operand, cast beforehand) on
   the same inputs.

Prints a JSON line a measurement, with the card's name and power limit,
and writes them all to chiprun_out/csr_bf16_probe.json.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from spmm_denseblock_tpu_torch.formats.csr import random_csr  # noqa: E402
from spmm_denseblock_tpu_torch.io.datasets import load_dataset  # noqa: E402
from spmm_denseblock_tpu_torch.models.graph import sym_norm_adjacency  # noqa: E402
from spmm_denseblock_tpu_torch.ops import _kernels  # noqa: E402
from spmm_denseblock_tpu_torch.ops.plan import Plan  # noqa: E402
from spmm_denseblock_tpu_torch.reorder import STRATEGIES, permutate  # noqa: E402

TP = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm_pallas")

SEED = 1234
ITERS = 50
IN_FLIGHT = "constexpr int kBf16InFlight = 4;"
THREADS = "constexpr int kBf16Threads = 64;"
MIN_CTAS = "constexpr int kBf16MinCtas = 12;"
LOADS = "constexpr int kBf16Loads = 1;"
GATHER = "Rows<TX>::template load<V>(w[u][j], xs + ck * F + f);"


def _shape(in_flight: int, threads: int, ctas: int) -> dict:
    return {IN_FLIGHT: f"constexpr int kBf16InFlight = {in_flight};",
            THREADS: f"constexpr int kBf16Threads = {threads};",
            MIN_CTAS: f"constexpr int kBf16MinCtas = {ctas};"}


# the tree's kernel: 4 rows in flight, CTAs of 64 threads, 12 an SM
VARIANTS = {
    "in flight 8, 256 threads, 3 CTAs": _shape(8, 256, 3),
    "in flight 8, 64 threads, 12 CTAs": _shape(8, 64, 12),
    "in flight 4, 256 threads, 3 CTAs": _shape(4, 256, 3),
    "in flight 4, 128 threads, 6 CTAs": _shape(4, 128, 6),
    "in flight 4, 64 threads, 16 CTAs": _shape(4, 64, 16),
    "in flight 8, 256 threads, 4 CTAs": _shape(8, 256, 4),
    "two loads a lane": {LOADS: "constexpr int kBf16Loads = 2;"},
    "gathers cut": {GATHER: "Rows<TX>::template load<V>(w[u][j], xs + (ck & 63) * F + f);"},
}
CHECKED = [name for name in VARIANTS if name != "gathers cut"]
# f32 rows rounded to bf16 in the gather: the operand's Rows on float and
# an entry that takes the f32 operand, appended to the tree's source
IN_GATHER = "in-gather rounding"
IN_GATHER_SRC = r'''
namespace {
// f32 rows rounded to bf16 in registers (round to nearest even, as
// .to(torch.bfloat16)), packed as the bf16 loads pack them
__device__ __forceinline__ uint32_t round2(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
template <>
struct Rows<float> {
  template <int V>
  static __device__ __forceinline__ void load(uint32_t (&w)[(V + 1) / 2],
                                              const float* p) {
    if constexpr (V == 1) {
      w[0] = round2(__ldg(p), 0.f);
    } else {
#pragma unroll
      for (int h = 0; h < V / 4; ++h) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(p) + h);
        w[2 * h] = round2(a.x, a.y);
        w[2 * h + 1] = round2(a.z, a.w);
      }
    }
  }
};
}  // namespace

extern "C" int sdb_csr_spmm_bf16_f32x(const void* seg_start, const void* seg_end,
                                      const void* seg_dest, const void* cols,
                                      const void* vals, const void* dense, void* out,
                                      void* partial, const void* split_row,
                                      const void* part_ptr, int64_t n_seg,
                                      int64_t n_split, int64_t F, int64_t W,
                                      void* stream) {
  return csr_bf16_spmm<float>(seg_start, seg_end, seg_dest, cols, vals, dense, out,
                              partial, split_row, part_ptr, n_seg, n_split, F, W,
                              stream);
}
'''
CSR_SOURCE = _kernels.SOURCES.index(ROOT / "spmm_denseblock_tpu_torch" / "csrc" / "csr_spmm.cu")


def variant_sources() -> dict:
    """{name: SOURCES tuple}: the tree's first, then each variant, all
    built at once (one nvcc each)."""
    src = _kernels.SOURCES[CSR_SOURCE]
    text = src.read_text()
    out = {"as is": _kernels.SOURCES}
    edits = {**VARIANTS, IN_GATHER: {}}
    for name, subs in edits.items():
        t = text
        for old, new in subs.items():
            if old not in t:
                raise SystemExit(f"variant {name!r}: {old!r} is not in {src.name}")
            t = t.replace(old, new)
        if name == IN_GATHER:
            t += IN_GATHER_SRC
        path = ROOT / "tmp" / "variants" / name.replace(" ", "_").replace(",", "") / src.name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(t)
        sources = list(_kernels.SOURCES)
        sources[CSR_SOURCE] = path
        out[name] = tuple(sources)
    _kernels.SOURCES = tuple({s for v in out.values() for s in v})
    _kernels.build()
    return out


def use(sources) -> None:
    _kernels.SOURCES = sources
    _kernels._libs = None
    _kernels.load()


def cuda_ms(fn, iters: int = ITERS) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graphs() -> dict:
    """{name: (CSR, F)} as chip_smoke.py's phase 8d builds them."""
    cache = str(ROOT / "build" / "datasets")
    ddi = load_dataset("ogbl-ddi", cache_dir=cache, seed=SEED)
    ddi = permutate(STRATEGIES["rcmk"](ddi), ddi)
    arxiv = load_dataset("ogbn-arxiv", cache_dir=cache, scale=1.0, seed=SEED)
    arxiv = permutate(STRATEGIES["gorder"](arxiv), arxiv)
    return {"ddi": (sym_norm_adjacency(ddi), 256),
            "serve gorder": (sym_norm_adjacency(arxiv), 128),
            "op csr": (random_csr(2e-3, 1 << 17, seed=SEED), 512)}


def arxiv_orderings() -> dict:
    """{ordering: CSR}: the ogbn-arxiv stand-in under chip_smoke.py's
    REORDER_ORDERINGS (its reorder phase's graphs, no normalization)."""
    arxiv = load_dataset("ogbn-arxiv", cache_dir=str(ROOT / "build" / "datasets"),
                         scale=1.0, seed=SEED)
    return {name: permutate(STRATEGIES[name](arxiv), arxiv)
            for name in ("original", "rcmk", "rabbit", "gorder")}


def in_row_order(plan) -> Plan:
    """The plan with its segments in row order (f32 K10's), not longest
    first (each segment's sum is its own, so the answer keeps its bits)."""
    a = list(plan.arrays)
    order = torch.argsort(a[5], stable=True)
    for i in (5, 6, 7):
        a[i] = a[i][order]
    return Plan(a, plan.apply_fn, plan.statics, device=a[5].device)


def in_gather_call(plan, x, W: int):
    """The in-gather rounding entry on the f32 operand x with the plan's
    arrays, in strips of W; returns (call, out)."""
    lib = _kernels.load()["csr_spmm"]
    fn = lib.sdb_csr_spmm_bf16_f32x
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    a = plan.arrays
    n_rows, F = plan.statics[0], x.shape[1]
    out = torch.empty(n_rows, F, device=x.device)
    partial = torch.empty(plan.statics[4], F, device=x.device)
    tensors = (a[5], a[6], a[7], a[0], a[2], x, out, partial, a[8], a[9])

    def call():  # holds the tensors, the scratch too, while it lives
        rc = fn(*(t.data_ptr() for t in tensors), a[5].shape[0], a[8].shape[0], F, W,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"sdb_csr_spmm_bf16_f32x: cudaError_t {rc}")
    return call, out


def cusparse_bf16(csr, x):
    a = torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr.astype(np.int64), device="cuda"),
        torch.as_tensor(csr.indices.astype(np.int64), device="cuda"),
        torch.as_tensor(csr.values(), device="cuda").to(torch.bfloat16), csr.shape,
        check_invariants=False)
    xb = x.to(torch.bfloat16)
    return lambda: a @ xb


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    sources = variant_sources()
    use(sources["as is"])
    l2 = TP._l2_bytes(0)
    cases = {}
    for name, (csr, F) in graphs().items():
        x = torch.as_tensor(np.random.default_rng(SEED).standard_normal(
            (csr.n_cols, F)).astype(np.float32), device="cuda")
        plan = TP.csr_spmm_pallas_plan(csr, precision="default", grad=False, device="cuda")
        cases[name] = (csr, F, x, x.to(torch.bfloat16), plan)
    records = []

    def record(**r):
        r["card"] = card
        records.append(r)
        print(json.dumps(r), flush=True)

    # 1. the variants, A B .. B A
    want = {name: c[4](c[2]) for name, c in cases.items()}
    order = list(sources)
    for run, vname in enumerate(order + order[::-1]):
        use(sources[vname])
        for name, (csr, F, x, xb, plan) in cases.items():
            got = plan(x)
            torch.cuda.synchronize()
            same = bool(torch.equal(got, want[name]))
            if vname in CHECKED + ["as is", IN_GATHER] and not same:
                raise AssertionError(f"{vname} on {name}: not the tree's bits")
            record(part="variant", variant=vname, run=run, graph=name, F=F,
                   W=TP.csr_bf16_strip_width(csr.n_cols, F, l2),
                   whole_ms=cuda_ms(lambda: plan(x)), kernel_ms=cuda_ms(lambda: plan(xb)),
                   same_bits=same)
    rule = TP.csr_bf16_strip_width

    def forced(plan, x, xb, W, want, label):
        TP.csr_bf16_strip_width = lambda K, F_, l2_, W=W: W
        try:
            if not torch.equal(plan(x), want):
                raise AssertionError(f"{label} at W={W}: not the tree's bits")
            return cuda_ms(lambda: plan(x)), cuda_ms(lambda: plan(xb))
        finally:
            TP.csr_bf16_strip_width = rule

    # 2. strips and segment order on the serve graph and on arxiv under
    # each ordering
    use(sources["as is"])
    strip_cases = {"serve gorder": cases["serve gorder"][:4]}
    for name, csr in arxiv_orderings().items():
        x = torch.as_tensor(np.random.default_rng(SEED).standard_normal(
            (csr.n_cols, 128)).astype(np.float32), device="cuda")
        strip_cases[f"arxiv {name}"] = (csr, 128, x, x.to(torch.bfloat16))
    for run in range(2):
        for name, (csr, F, x, xb) in strip_cases.items():
            plan = TP.csr_spmm_pallas_plan(csr, precision="default", grad=False,
                                           device="cuda")
            want_s = plan(x)
            for seg_order, p in (("longest first", plan), ("row order", in_row_order(plan))):
                for W in (128, 64, 32) if run == 0 else (32, 64, 128):
                    whole, kernel = forced(p, x, xb, W, want_s, name)
                    record(part="strips", run=run, graph=name, W=W, n_strips=-(-F // W),
                           segments=seg_order, whole_ms=whole, kernel_ms=kernel)
            del plan, p, want_s
    # 3. the cast, with the yardsticks
    use(sources[IN_GATHER])
    for run in range(2):
        for name in ("ddi", "serve gorder"):
            csr, F, x, xb, plan = cases[name]
            W32 = TP.csr_bf16_strip_width(csr.n_cols, F, l2 // 2)
            call, out = in_gather_call(plan, x, W32)
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want[name]):
                raise AssertionError(f"in-gather rounding on {name}: not the tree's bits")
            f32 = TP.csr_spmm_pallas_plan(csr, grad=False, device="cuda")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                lib = cusparse_bf16(csr, x)
                lib_ms = cuda_ms(lib)
            record(part="cast", run=run, graph=name, F=F,
                   separate_cast_ms=cuda_ms(lambda: plan(x)),
                   cast_alone_ms=cuda_ms(lambda: x.to(torch.bfloat16)),
                   in_gather_ms=cuda_ms(call), in_gather_W=W32,
                   f32_k10_ms=cuda_ms(lambda: f32(x)), cusparse_bf16_ms=lib_ms)
            del f32, call, out
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "csr_bf16_probe.json").write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
