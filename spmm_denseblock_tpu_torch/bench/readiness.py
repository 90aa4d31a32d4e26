"""Multi-rank readiness harness (twin of the JAX package's
``scripts/readiness_matrix.py``): strategy {halo, ring, allgather} x
dtype {f32, bf16, int8} x rank counts of the distributed BSR SpMM
(``parallel.dist_bsr_spmm_plan``), each row with its measured nnz/s,
RETENTION (rate(n) / rate(first count)), per-rank efficiency, the plan's
build seconds against a budget, and the H100 NVLink model's prediction
for the same shape (``parallel.comms.efficiency_model``, the ``ici_model_*``
columns under JAX's names).

    python -m spmm_denseblock_tpu_torch.bench.readiness --devices 1,2,4
    python -m spmm_denseblock_tpu_torch.bench.readiness --devices 1,2 --device cpu

Each rank count is one world of ranks on this machine
(``parallel.world.run_world``): on the card one GPU a rank over NCCL where
there are enough, else every rank on the one GPU over gloo
(``backend_for``); with --device cpu, CPU ranks over gloo. A world runs
every (strategy, dtype) combination at its count, so the matrix starts
len(--devices) worlds. Ranks that share a machine or a card cannot show
scaling: read `retention`, which is not scaling; on a card a rank, the
`efficiency` column is the measurement. Times are the slowest rank's
(``bench.timing.time_chained`` on the card, ``time_synced`` on CPU ranks,
as JAX times the TPU and its CPU mesh).

The records carry JAX's keys, with backend "cuda" or "cpu-world", plus
"device". Two departures from JAX:
- --out defaults to build/readiness/readiness_matrix.jsonl under the
  working directory, never into benchmarks/;
- a combination that raises, misses its error gate or its plan budget is
  printed as JAX prints it (and recorded where JAX records it), but main
  then raises RuntimeError instead of carrying on silently.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import numpy as np
import torch

DTYPES = {"f32": None, "bf16": torch.bfloat16, "int8": torch.int8}
TOL = {"f32": 1e-4, "bf16": 5e-3, "int8": 5e-2}
ITEMSIZE = {"f32": 4, "bf16": 2, "int8": 1}
DEFAULT_OUT = "build/readiness/readiness_matrix.jsonl"


def build_graph(kind: str, n_block_rows: int, b: int, seed: int = 1234):
    """Banded (halo-eligible), powerlaw-unstructured (rabbit-reordered) or
    random BSR test matrix, bit-equal to the JAX script's."""
    from spmm_denseblock_tpu_torch.formats.bsr import BSR, random_bsr

    if kind == "powerlaw":
        from spmm_denseblock_tpu_torch.convert.csr2bsr import csr_to_bsr
        from spmm_denseblock_tpu_torch.io.datasets import synthetic_powerlaw
        from spmm_denseblock_tpu_torch.reorder import STRATEGIES, permutate

        n = n_block_rows * b
        csr = synthetic_powerlaw(n, n * 16, seed=seed)
        perm = STRATEGIES["rabbit"](csr)
        return csr_to_bsr(permutate(perm, csr), b)
    if kind == "banded":
        # block-tridiagonal-ish band: every block col within +-1 block
        # stripe of its row at 8-rank granularity (halo=1 eligible)
        rng = np.random.default_rng(seed)
        rows, cols = [], []
        width = max(2, n_block_rows // 16)
        for r in range(n_block_rows):
            lo = max(0, r - width)
            hi = min(n_block_rows, r + width + 1)
            k = min(hi - lo, 1 + rng.poisson(6))
            cs = rng.choice(np.arange(lo, hi), size=k, replace=False)
            rows.extend([r] * k)
            cols.extend(cs.tolist())
        rows = np.asarray(rows, np.int32)
        cols = np.asarray(cols, np.int32)
        order = np.lexsort((cols, rows))
        blocks = rng.standard_normal((rows.size, b, b)).astype(np.float32)
        return BSR.from_parts(rows[order], cols[order], blocks[order],
                              (n_block_rows * b, n_block_rows * b), b)
    if kind == "random":
        return random_bsr(1.6e-2, n_block_rows, block_size=b, seed=seed)
    raise ValueError(kind)


def _combination(device_type: str, bsr, x, want, strat: str, dt_name: str,
                 local_impl: str, mesh) -> dict:
    """One (strategy, dtype) on this rank of the mesh's world: {"plan_s",
    "rel", "secs", "wall_s"}."""
    import torch.distributed as dist

    from spmm_denseblock_tpu_torch.bench.timing import time_chained, time_synced
    from spmm_denseblock_tpu_torch.parallel import dist_bsr_spmm_plan
    from spmm_denseblock_tpu_torch.parallel.exchange import gather_output, rank_device

    t0 = time.time()
    dev = rank_device("cpu" if device_type == "cpu" else None)
    kw = dict(mesh=mesh, strategy=strat, local_impl=local_impl,
              dtype=DTYPES[dt_name], device=dev)
    if dt_name == "int8":
        kw["calibration"] = x[:2048]
    t_plan0 = time.time()
    plan = dist_bsr_spmm_plan(bsr, **kw)
    plan_s = time.time() - t_plan0
    xd = torch.as_tensor(x, device=dev)
    with torch.no_grad():
        got = gather_output(plan, plan(xd))[:, :64].float().cpu().numpy()
        rel = float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))
        dist.barrier()
        secs = (time_chained(plan, xd, iters=8) if device_type == "cuda"
                else time_synced(plan, xd, iters=6))
    return {"plan_s": plan_s, "rel": rel, "secs": secs, "wall_s": time.time() - t0}


def _readiness_rank(rank: int, nd: int, device_type: str, bsr, x, want, combos,
                    local_impl: str) -> dict:
    """Every combination at nd ranks on this rank: {(strategy, dtype):
    its result, or {"error": "Type: message"}}. A combination's failure
    is caught so that the next one runs, as JAX's loop goes on."""
    from spmm_denseblock_tpu_torch.parallel import make_mesh_1d

    if device_type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh_1d(nd, device_type=device_type)
    out = {}
    for strat, dt_name in combos:
        try:
            out[(strat, dt_name)] = _combination(device_type, bsr, x, want, strat,
                                                 dt_name, local_impl, mesh)
        except Exception as e:  # noqa: BLE001 - printed and raised by main
            out[(strat, dt_name)] = {"error": f"{type(e).__name__}: {e}",
                                     "trace": traceback.format_exc()}
    return out


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", default="1,2,4,8",
                    help="rank counts, one world each")
    ap.add_argument("--strategies", default="halo,ring,allgather")
    ap.add_argument("--dtypes", default="f32,bf16,int8")
    ap.add_argument("--graph", default="banded",
                    choices=["banded", "powerlaw", "random"])
    ap.add_argument("--n-block-rows", type=int, default=512)
    ap.add_argument("--block-size", type=int, default=64)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--local-impl", default="xla", choices=["xla", "pallas"])
    ap.add_argument("--plan-budget-s", type=float, default=10.0,
                    help="plan-build budget gate: a combination whose plan "
                         "takes longer fails")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="JSON lines appended here (default: %(default)s)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the ranks run (default: the card)")
    return ap


def main(argv=None) -> list:
    """Runs the matrix; appends and returns its records. Raises
    RuntimeError after the matrix when a combination failed."""
    from spmm_denseblock_tpu_torch.bench.harness import _device_name
    from spmm_denseblock_tpu_torch.ops._device import resolve_device
    from spmm_denseblock_tpu_torch.ops.reference import spmm_scipy
    from spmm_denseblock_tpu_torch.parallel.comms import efficiency_model
    from spmm_denseblock_tpu_torch.parallel.world import backend_for, run_world

    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    backend = "cuda" if dev.type == "cuda" else "cpu-world"
    devices = [int(d) for d in args.devices.split(",")]
    combos = [(s, d) for s in args.strategies.split(",") for d in args.dtypes.split(",")]
    for _, d in combos:
        if d not in DTYPES:
            raise ValueError(f"unknown dtype {d!r}; use {sorted(DTYPES)}")

    bsr = build_graph(args.graph, args.n_block_rows, args.block_size)
    b, nnzb = bsr.b, int(bsr.nnzb)
    nnz = bsr.nnz_inside()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((bsr.shape[1], args.dim)).astype(np.float32)
    want = spmm_scipy(bsr, x[:, :64])
    print(f"[readiness] graph={args.graph} n={bsr.shape[0]} b={b} "
          f"nnzb={nnzb} dim={args.dim} backend={backend}", flush=True)

    per_count = {}
    for nd in devices:
        ranks = run_world(_readiness_rank, nd, backend=backend_for(dev, nd),
                          args=(dev.type, bsr, x, want, combos, args.local_impl),
                          timeout_s=900.0, threads=1 if dev.type == "cpu" else 2)
        per_count[nd] = ranks

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    records, failed = [], []
    for strat, dt_name in combos:
        rate1 = nd1 = None
        for nd in devices:
            res = [r[(strat, dt_name)] for r in per_count[nd]]
            errs = [r for r in res if "error" in r]
            if errs:
                print(f"[readiness] {strat} {dt_name} n={nd} FAILED: "
                      f"{errs[0]['error']}", flush=True)
                failed.append(f"{strat} {dt_name} n={nd}: {errs[0]['trace']}")
                continue
            secs = max(r["secs"] for r in res)
            plan_s = max(r["plan_s"] for r in res)
            rel = res[0]["rel"]
            ok = rel <= TOL[dt_name]
            rate = nnz / secs
            if rate1 is None:
                rate1, nd1 = rate, nd
            model = efficiency_model(
                strat if strat != "auto" else "allgather", nd, nnzb, b,
                bsr.shape[1], args.dim, itemsize=ITEMSIZE[dt_name],
                dtype_flops="bf16" if dt_name != "f32" else "f32",
            )
            rec = {
                "kind": "readiness_matrix", "backend": backend,
                "graph": args.graph, "strategy": strat,
                "dtype": dt_name, "devices": nd,
                "local_impl": args.local_impl,
                "n": int(bsr.shape[0]), "b": b, "nnzb": nnzb,
                "dim": args.dim, "ms": secs * 1e3,
                "nnz_per_s": rate,
                "retention": rate / rate1,
                "efficiency": (rate / nd) / (rate1 / nd1),
                "max_rel_err": rel, "tol": TOL[dt_name],
                "gate_ok": ok,
                "plan_s": round(plan_s, 2),
                "plan_budget_s": args.plan_budget_s,
                "plan_ok": plan_s <= args.plan_budget_s,
                "ici_model_efficiency": model["efficiency"],
                "ici_model_t_comp_us": model["t_comp_us"],
                "ici_model_t_comm_us": model["t_comm_us"],
                "wall_s": round(res[0]["wall_s"], 1),
                "ts": time.time(),
                "device": _device_name(dev),
            }
            with open(out, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
            records.append(rec)
            print(f"[readiness] {strat:9s} {dt_name:4s} n={nd}: "
                  f"{rec['ms']:8.2f} ms retention={rec['retention']:.2f} "
                  f"model_eff={model['efficiency']:.2f} "
                  f"plan={plan_s:.1f}s"
                  f"{'' if rec['plan_ok'] else ' OVER-BUDGET'} "
                  f"rel={rel:.1e} {'ok' if ok else 'FAIL'}", flush=True)
            if not (ok and rec["plan_ok"]):
                failed.append(f"{strat} {dt_name} n={nd}: rel {rel:.1e} (tol "
                              f"{TOL[dt_name]}), plan {plan_s:.2f} s (budget "
                              f"{args.plan_budget_s} s)")
    if failed:
        raise RuntimeError(f"readiness: {len(failed)} combination(s) failed:\n"
                           + "\n".join(failed))
    print("[readiness] done", flush=True)
    return records


if __name__ == "__main__":
    # the package's copy of main, so that the worlds' ranks find
    # _readiness_rank under the module's own name
    from spmm_denseblock_tpu_torch.bench.readiness import main as _main

    _main()
