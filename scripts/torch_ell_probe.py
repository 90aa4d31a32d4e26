"""Time the f32 ELL tier's kernel (sdb_ell_spmm) on the arxiv benchmark
graph, on one card:

    python3 scripts/torch_ell_probe.py [--out build/ell_probe.json]

The graph is the one the gcn-arxiv cells serve (portbench's stand-in,
gorder, sym_norm_adjacency) and the plan ``impl="hybrid"`` builds there
(the route ``impl="auto"`` took before it priced by the card's kernels):
a hybrid of K1 and the ELL tier. At F = 128 and 256 it times the
remainder's ELL kernel at ell_strip_width's strip width and at others,
its segments longest first (the plan's) and in row order, source
variants of ``csrc/csr_spmm.cu`` (text substitutions in VARIANTS, built
under ``build/ell_variants/``), K10's kernel on the same flat arrays, the
chunk loop that ran before the kernel (its plain version, on the card),
K10 on the whole graph, cuSPARSE on the remainder
(``torch.sparse_csr_tensor @ X``, a yardstick only), the remainder's CSR
bytes bound, the whole hybrid call and ``impl="csr_ell"`` on the whole
graph (its kernel and its plain version). Every answer is held to the plain
version's within 1e-5, and every variant to the tree's bit for bit;
every time is the mean of CUDA events over a run of calls, the
alternatives twice, in turns. Last, GCN requests of the cells' widths
through the plan under torch.profiler (CUDA activity) with program
tracing on: device operations and device ms a request, the ELL kernel's
share, and the leaf's sdb.kernel/csr_ell count against its calls.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import graphgen, trace, work  # noqa: E402
from spmm_denseblock_tpu_torch.bench.timing import cuda_ms  # noqa: E402
from spmm_denseblock_tpu_torch.formats.csr import CSR  # noqa: E402
from spmm_denseblock_tpu_torch.models.gnn import gcn_apply  # noqa: E402
from spmm_denseblock_tpu_torch.models.graph import sym_norm_adjacency  # noqa: E402
from spmm_denseblock_tpu_torch.ops import _kernels  # noqa: E402
from spmm_denseblock_tpu_torch.ops.csr_spmm_pallas import csr_spmm_pallas_plan  # noqa: E402
from spmm_denseblock_tpu_torch.ops.dispatch import _explicit_hybrid, spmm_plan  # noqa: E402
from spmm_denseblock_tpu_torch.ops.plan import run  # noqa: E402
from spmm_denseblock_tpu_torch.reorder import reorder  # noqa: E402
from spmm_denseblock_tpu_torch.utils import profiling  # noqa: E402

# the package's ops exports a function of the module's name
E = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm_ell")
ITERS = 50
DEV = "cuda"
SOURCE = ROOT / "spmm_denseblock_tpu_torch/csrc/csr_spmm.cu"
# name -> text substitutions of the source
VARIANTS = {
    "in-flight 8": [("kEllInFlight = 4;", "kEllInFlight = 8;")],
    "in-flight 2": [("kEllInFlight = 4;", "kEllInFlight = 2;")],
    "CTAs of 128": [("kEllThreads = 64;", "kEllThreads = 128;"),
                    ("kEllMinCtas = 12;", "kEllMinCtas = 6;")],
    "16 CTAs (64 registers)": [("kEllMinCtas = 12;", "kEllMinCtas = 16;")],
}


def rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def build_variants() -> dict:
    """name -> the variant's sdb_ell_spmm, all built at once."""
    out_dir = ROOT / "build/ell_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text, jobs = SOURCE.read_text(), {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        src = text
        for old, new in subs:
            assert old in src, (name, old)
            src = src.replace(old, new)
        cu, so = out_dir / f"ell_v{i}.cu", out_dir / f"libell_v{i}.so"
        cu.write_text(src)
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-I", str(_kernels.INCLUDE_DIR),
               "-o", str(so), str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (so, proc) in jobs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, err
        fn = ctypes.CDLL(str(so)).sdb_ell_spmm
        fn.argtypes, fn.restype = _kernels._SIGNATURES["sdb_ell_spmm"][1], ctypes.c_int
        fns[name] = fn
    return fns


def requests(plan, n: int, dims, n_req: int = 20) -> dict:
    """n_req GCN requests (widths dims, seeded weights) through plan under
    torch.profiler's CUDA activity, program tracing on: device operations
    (kernels, copies, fills) and device ms a request, the ELL kernel's ms
    a request, and the program's counters over the n_req requests."""
    g = torch.Generator(device=DEV).manual_seed(11)
    params = [{"w": torch.randn(a, b, device=DEV, generator=g) / a ** 0.5,
               "b": torch.zeros(b, device=DEV)} for a, b in zip(dims[:-1], dims[1:])]
    x = torch.randn(n, dims[0], device=DEV, generator=g)
    with torch.no_grad():
        gcn_apply(params, plan, x)
        torch.cuda.synchronize()
        prev = profiling.enable(True)
        profiling.take()
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(n_req):
                    gcn_apply(params, plan, x)
                torch.cuda.synchronize()
            counts = profiling.take()["counts"]
        finally:
            profiling.enable(prev)
    path = ROOT / "build/ell_probe_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = [e for e in trace.load(str(path)) if e.get("ph") == "X"
              and e.get("cat") in trace.DEVICE_CATS]
    path.unlink()
    ell = [e for e in events if "ell_row_kernel" in e["name"]]
    return {"requests": n_req, "launches_a_request": len(events) / n_req,
            "device_ms_a_request": sum(float(e["dur"]) for e in events) / 1e3 / n_req,
            "ell_ms_a_request": sum(float(e["dur"]) for e in ell) / 1e3 / n_req,
            "ell_launches_a_request": len(ell) / n_req, "counts": counts}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/ell_probe.json")
    ap.add_argument("--requests-only", action="store_true",
                    help="only the requests (a checkout without the kernel too)")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    config = json.loads((ROOT / "portbench/configs/gcn-arxiv.json").read_text())
    n, edges = graphgen.load_edges(config["graph"])
    adj = sym_norm_adjacency(reorder(CSR.from_edges(edges, n_rows=n),
                                     config["ordering"])[0])
    plan = spmm_plan(adj, impl="hybrid", feat_dim=128, grad=False)
    if args.requests_only:
        req = requests(plan, n, config["dims"])
        print(f"[probe] {card}; GCN {config['dims']} requests: {req}", flush=True)
        return
    variants = build_variants()
    ell = plan.subplans[1]
    assert ell.name == "csr_ell", [p.name for p in plan.subplans]
    # the same plan with its segments in row order (the bits are the same)
    orig = E.row_segments
    E.row_segments = lambda *a, **k: orig(*a, **{**k, "longest_first": False})
    try:
        ell_rows = spmm_plan(adj, impl="hybrid", feat_dim=128, grad=False).subplans[1]
    finally:
        E.row_segments = orig
    # the same division the router made, for the yardstick and the bound
    rem = _explicit_hybrid(adj, "hybrid", 128, {}).remainder
    assert rem.nnz == ell.nnz, (rem.nnz, ell.nnz)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        lib = torch.sparse_csr_tensor(
            torch.as_tensor(np.asarray(rem.indptr, np.int64)),
            torch.as_tensor(np.asarray(rem.indices, np.int64)),
            torch.as_tensor(rem.values().astype(np.float32)), rem.shape).cuda()
    k10 = csr_spmm_pallas_plan(adj, grad=False)
    whole = spmm_plan(adj, impl="csr_ell", grad=False)  # the ELL tier on all of A
    tree = _kernels.load()["csr_spmm"]
    record = {"card": card, "n": n, "nnz": adj.nnz, "remainder_nnz": rem.nnz,
              "remainder_slots": ell.positions, "n_segments": int(ell.arrays[-5].numel()),
              "split_rows": int(ell.arrays[-2].numel()), "widths": {}}
    print(f"[probe] {card}; arxiv {n} rows, {adj.nnz} nonzeros, remainder "
          f"{rem.nnz} in {ell.positions} ELL slots, {record['n_segments']} "
          f"segments, {record['split_rows']} split rows", flush=True)
    rng = np.random.default_rng(7)
    for F in (128, 256):
        x = torch.as_tensor(rng.standard_normal((n, F)).astype(np.float32), device="cuda")
        want = run(ell, x, plain=True)
        before = _kernels.ell_spmm.launches
        got = ell(x)
        torch.cuda.synchronize()
        assert _kernels.ell_spmm.launches == before + 1
        err = rel(got, want)
        W0 = E.ell_strip_width(n, F, E._l2_bytes(0))
        row = {"W": W0, "rel_vs_plain": err}
        out = torch.empty(n, F, device="cuda")
        part = torch.empty(ell.statics[4], F, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def call(fn, p, W, k10=False):
            """fn (sdb_ell_spmm, or with k10 a C entry with sdb_csr_spmm's
            arguments) on plan p's arrays, one head, no seg_delta."""
            seg_start, seg_end, seg_dest, split_row, part_ptr = p.arrays[-5:]
            args = (seg_start.data_ptr(), seg_end.data_ptr(), seg_dest.data_ptr(),
                    *(() if k10 else (0,)),
                    p.arrays[1].data_ptr(), p.arrays[2].data_ptr(), x.data_ptr(),
                    out.data_ptr(), part.data_ptr(), split_row.data_ptr(),
                    part_ptr.data_ptr(), seg_start.numel(), split_row.numel(), F, W,
                    *(() if k10 else (1, 0)), stream)

            def go():
                rc = fn(*args)
                assert rc == 0, rc
                return out
            return go

        fns = {f"tree W={W0} longest": lambda: ell(x),
               f"tree W={W0} rows": lambda: ell_rows(x)}
        for W in (64, 128):
            if W != W0 and W <= F:
                fns[f"tree W={W} longest"] = call(tree.sdb_ell_spmm, ell, W)
        for name, fn in variants.items():
            fns[f"{name} W={W0}"] = call(fn, ell, W0)
        fns[f"K10's kernel W={F}"] = call(tree.sdb_csr_spmm, ell, F, k10=True)
        times = {}
        for rep in range(2):  # turns: every variant twice, in opposite orders
            for name in (list(fns) if rep == 0 else list(fns)[::-1]):
                res = fns[name]()
                if name.startswith("K10"):
                    assert rel(res, want) < 1e-5, name
                else:
                    assert torch.equal(res, got), name
                times.setdefault(name, []).append(cuda_ms(fns[name], ITERS))
        row["kernel_ms"] = times
        row["plain_ms"] = cuda_ms(lambda: run(ell, x, plain=True), 3, warmup=1)
        row["k10_whole_graph_ms"] = cuda_ms(lambda: k10(x), ITERS)
        row["ell_whole_graph_ms"] = cuda_ms(lambda: whole(x), ITERS)
        row["ell_whole_graph_plain_ms"] = cuda_ms(lambda: run(whole, x, plain=True), 3,
                                                  warmup=1)
        row["hybrid_ms"] = cuda_ms(lambda: plan(x), ITERS)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            row["cusparse_remainder_ms"] = cuda_ms(lambda: lib @ x, ITERS)
            row["cusparse_rel"] = rel(lib @ x, want)
        nbytes = work.csr_spmm_bytes(rem.nnz, n, n, F)
        row["bound_ms"] = 1e3 * max(work.csr_spmm_ops(rem.nnz, F) / work.PEAK_OPS_S["f32"],
                                    nbytes / work.HBM_BYTES_S)
        record["widths"][F] = row
        print(f"[probe] F={F}: kernel (W={W0}) vs plain {err:.3e}; plain "
              f"{row['plain_ms']:.3f} ms; K10 whole graph {row['k10_whole_graph_ms']:.4f}; "
              f"csr_ell whole graph {row['ell_whole_graph_ms']:.4f} (plain "
              f"{row['ell_whole_graph_plain_ms']:.3f}); "
              f"hybrid call {row['hybrid_ms']:.4f}; cuSPARSE remainder "
              f"{row['cusparse_remainder_ms']:.4f}; bound {row['bound_ms']:.4f} ms",
              flush=True)
        for name, v in times.items():
            print(f"[probe] F={F}: {name:<28} {v[0]:.4f} {v[1]:.4f} ms", flush=True)
    dims = config["dims"]
    record["requests"] = req = requests(plan, n, dims)
    print(f"[probe] GCN {dims} requests: {req['launches_a_request']:.1f} device "
          f"operations and {req['device_ms_a_request']:.3f} device ms a request, ELL "
          f"kernel {req['ell_ms_a_request']:.3f} ms in {req['ell_launches_a_request']:.1f} "
          f"launches; counters over {req['requests']}: {req['counts']}", flush=True)
    path = ROOT / args.out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=1))
    print(f"[probe] written {path}", flush=True)


if __name__ == "__main__":
    main()
