"""Time the GAT's edge attention on the gat-arxiv benchmark graph, on one
card:

    python3 scripts/torch_gat_probe.py [--out build/gat_probe.json]

The graph is the one the gat-arxiv cell serves (portbench's stand-in,
``gat_pattern``, gorder) and the plan the one ``spmm_plan(...,
values="call")`` builds there: the ELL tier's pattern plan. First the
registers and spills ptxas gives each ``ell_row_kernel`` instance. Then
at the cell's aggregation widths, 3 heads of 250 (F = 750) and of 40
(F = 120), with seeded values (3, nnz): the kernel's answer against its
plain version (the chunk loop on the scattered values) and float64;
the times of one launch for the three heads (the plan's design), of
three launches of one head each on contiguous head operands (the other
design; with and without the copies that make its operands and join its
outputs), of the tree's kernel with 8-byte loads turned off (a source
variant, built under ``build/gat_variants/``), of cuSPARSE on each head
(``torch.sparse_csr_tensor @ X``, a yardstick only), and the bytes bound
the benchmark counts. Last, GAT requests at the source's widths on the
plan route and on the segment route: device ms a request (CUDA events),
peak memory above what was held, the routes' answers against each other,
and the plan route's device operations under torch.profiler. Every time
is the mean of CUDA events over a run of calls; the designs run twice,
in turns.
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
from spmm_denseblock_tpu_torch import models as M  # noqa: E402
from spmm_denseblock_tpu_torch.bench.timing import cuda_ms  # noqa: E402
from spmm_denseblock_tpu_torch.formats.csr import CSR  # noqa: E402
from spmm_denseblock_tpu_torch.models.graph import gat_pattern  # noqa: E402
from spmm_denseblock_tpu_torch.ops import _kernels  # noqa: E402
from spmm_denseblock_tpu_torch.ops.dispatch import spmm_plan  # noqa: E402
from spmm_denseblock_tpu_torch.ops.plan import run  # noqa: E402
from spmm_denseblock_tpu_torch.reorder import reorder  # noqa: E402

E = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm_ell")
SOURCE = ROOT / "spmm_denseblock_tpu_torch/csrc/csr_spmm.cu"
ITERS = 30
# name -> text substitutions of the source
VARIANTS = {"no 8-byte loads": [(
    "const bool vec2 = !vec4 && D % 2 == 0 && aligned(8);", "const bool vec2 = false;")]}


def rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def ptxas() -> list:
    """ptxas's line for each ell_row_kernel instance (registers, spills)."""
    out = ROOT / "build/gat_variants/ptxas.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-I",
           str(_kernels.INCLUDE_DIR), "-o", str(out), str(SOURCE)]
    p = subprocess.run(cmd, capture_output=True, text=True, check=True)
    lines, fn = [], None
    for line in (p.stdout + p.stderr).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif fn and "ell_row_kernel" in fn and ("registers" in line or "spill" in line):
            lines.append((fn, line.strip()))
    filt = Path(_kernels._nvcc()).with_name("cu++filt")
    names = {fn: fn for fn, _ in lines}
    if filt.exists():
        shown = subprocess.run([str(filt)], input="\n".join(names), capture_output=True,
                               text=True).stdout.splitlines()
        names.update(zip(names, shown))
    return [f"{names[fn].split('>(')[0]}>: {line}" for fn, line in lines]


def build_variants() -> dict:
    """name -> the variant's sdb_ell_spmm, all built at once."""
    out_dir = ROOT / "build/gat_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text, jobs = SOURCE.read_text(), {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        src = text
        for old, new in subs:
            assert old in src, (name, old)
            src = src.replace(old, new)
        cu, so = out_dir / f"gat_v{i}.cu", out_dir / f"libgat_v{i}.so"
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


def variant_call(fn, plan, x, v, out, part):
    """fn (a variant's sdb_ell_spmm) on the pattern plan's arrays, the
    call values v (H, nnz) and x, into out."""
    _, cols, _, seg_delta, seg_start, seg_end, seg_dest, split_row, part_ptr = plan.arrays
    F = x.shape[1]
    W = E.ell_strip_width(x.shape[0], F // v.shape[0], E._l2_bytes(0))
    args = (seg_start.data_ptr(), seg_end.data_ptr(), seg_dest.data_ptr(),
            seg_delta.data_ptr(), cols.data_ptr(), v.data_ptr(), x.data_ptr(),
            out.data_ptr(), part.data_ptr(), split_row.data_ptr(), part_ptr.data_ptr(),
            seg_start.numel(), split_row.numel(), F, W, v.shape[0], v.shape[1],
            torch.cuda.current_stream().cuda_stream)

    def go():
        assert fn(*args) == 0
        return out
    return go


def forward(apply, params, x, route_plan: bool):
    """apply(params, x) on the route named, whatever the call needs: the
    segment route without a gradient, for its memory beside the plan's."""
    h = x
    for i, p in enumerate(params):
        last = i == len(params) - 1
        h = apply.layer(p, h, not last, route_plan)
        if not last:
            h = torch.nn.functional.elu(h)
    return h


def requests(pattern, n: int, dims, heads: int, plan) -> dict:
    """GAT requests on both routes, without a gradient: device ms, peak
    memory above what was held, the answers against each other, the plan
    route's device operations a request under torch.profiler."""
    params = M.tree_map(lambda t: t.cuda(), M.init_gat(
        dims, heads, torch.Generator().manual_seed(5)))
    x = torch.randn(n, dims[0], device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(6))
    rec = {}
    outs = {}
    apply = M.make_gat_apply(pattern, heads, plan=plan)
    for route in ("plan", "segment"):
        def call():
            return forward(apply, params, x, route == "plan")
        with torch.no_grad():
            outs[route] = call()
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            call()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - held
            ms = cuda_ms(call, 10 if route == "plan" else 3, warmup=1)
        rec[route] = {"device_ms": ms, "peak_above_held_gb": peak / 1e9}
        if route == "plan":
            with torch.no_grad(), torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            path = ROOT / "build/gat_probe_trace.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(path))
            events = [e for e in trace.load(str(path)) if e.get("ph") == "X"
                      and e.get("cat") in trace.DEVICE_CATS]
            path.unlink()
            by_name = {}
            for e in events:
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) / 1e4
            rec["plan"]["operations_a_request"] = len(events) / 10
            rec["plan"]["profiled_device_ms"] = sum(by_name.values())
            rec["plan"]["top_ms_a_request"] = sorted(
                ([k[:70], v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:14]
        torch.cuda.empty_cache()
    rec["plan_vs_segment_rel"] = rel(outs["plan"], outs["segment"])
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/gat_probe.json")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    record = {"card": card, "ptxas": ptxas()}
    for line in record["ptxas"]:
        print(f"[probe] ptxas {line}", flush=True)
    config = json.loads((ROOT / "portbench/configs/gat-arxiv.json").read_text())
    n, edges = graphgen.load_edges(config["graph"])
    pattern, _ = reorder(gat_pattern(CSR.from_edges(edges, n_rows=n)),
                         config["ordering"])
    heads = config["heads"]
    plan = spmm_plan(pattern, values="call")
    variants = build_variants()
    record.update(n=n, nnz=pattern.nnz, slots=int(plan.arrays[1].numel()),
                  segments=int(plan.arrays[4].numel()),
                  split_rows=int(plan.arrays[-2].numel()), widths={})
    print(f"[probe] {card}; {n} rows, {pattern.nnz} entries in {record['slots']} "
          f"slots, {record['segments']} segments, {record['split_rows']} split rows",
          flush=True)
    rng = np.random.default_rng(7)
    v = torch.as_tensor(rng.random((heads, pattern.nnz), dtype=np.float32),
                        device="cuda")
    indptr = torch.as_tensor(np.asarray(pattern.indptr, np.int64))
    indices = torch.as_tensor(np.asarray(pattern.indices, np.int64))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        libs = [torch.sparse_csr_tensor(indptr, indices, v[h].cpu(),
                                        (n, n)).cuda() for h in range(heads)]
    for D in (250, 40):
        F = heads * D
        x = torch.as_tensor(rng.standard_normal((n, F)).astype(np.float32),
                            device="cuda")
        before = _kernels.ell_spmm.launches
        got = plan(x, values=v)
        torch.cuda.synchronize()
        assert _kernels.ell_spmm.launches == before + 1
        want = run(plan, x, plain=True, values=v)
        xh = [x[:, h * D:(h + 1) * D].contiguous() for h in range(heads)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            lib_out = torch.cat([libs[h] @ xh[h] for h in range(heads)], 1)
        row = {"F": F, "W": E.ell_strip_width(n, D, E._l2_bytes(0)),
               "rel_vs_plain": rel(got, want), "cusparse_rel": rel(lib_out, want)}
        out = torch.empty_like(got)
        part = torch.empty(plan.statics[4], F, device="cuda")
        fns = {
            "one launch, 3 heads": lambda: plan(x, values=v),
            "3 launches on head operands": lambda: [plan(xh[h], values=v[h])
                                                    for h in range(heads)],
            "3 launches with copies": lambda: torch.cat([plan(
                x[:, h * D:(h + 1) * D].contiguous(), values=v[h])
                for h in range(heads)], 1),
        }
        for name, fn in variants.items():
            fns[name] = variant_call(fn, plan, x, v, out, part)
        assert torch.equal(fns["3 launches with copies"](), got)
        for name in variants:
            assert torch.equal(fns[name](), got), name
        times = {}
        for rep in range(2):
            for name in (list(fns) if rep == 0 else list(fns)[::-1]):
                times.setdefault(name, []).append(cuda_ms(fns[name], ITERS))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            times["cusparse, 3 heads"] = [cuda_ms(
                lambda: [libs[h] @ xh[h] for h in range(heads)], ITERS)]
        row["ms"] = times
        row["bound_ms"] = 1e3 * max(
            work.csr_spmm_ops(pattern.nnz, F) / work.PEAK_OPS_S["f32"],
            work.csr_spmm_bytes(pattern.nnz, n, n, F, value_bytes=4 * heads)
            / work.HBM_BYTES_S)
        record["widths"][F] = row
        print(f"[probe] F={F} (3 x {D}, W={row['W']}): kernel vs plain "
              f"{row['rel_vs_plain']:.3e}, cuSPARSE vs plain {row['cusparse_rel']:.3e};"
              f" bound {row['bound_ms']:.4f} ms", flush=True)
        for name, t in times.items():
            print(f"[probe] F={F}: {name:<30} " + " ".join(f"{a:.4f}" for a in t) + " ms",
                  flush=True)
        del x, xh, got, want, lib_out, out, part
        torch.cuda.empty_cache()
    record["requests"] = req = requests(pattern, n, config["dims"], heads, plan)
    print(f"[probe] GAT {config['dims']} x {heads} heads requests: {req}", flush=True)
    path = ROOT / args.out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=1))
    print(f"[probe] written {path}", flush=True)


if __name__ == "__main__":
    main()
