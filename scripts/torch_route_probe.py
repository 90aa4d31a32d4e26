"""Calibrate the kernel pricing of ``impl="auto"``'s scorer on one card:

    python3 scripts/torch_route_probe.py [--out build/route_probe.json]

On the graph the gcn-arxiv cells serve (portbench's stand-in, gorder,
sym_norm_adjacency), at F = 128 and 256, it times ``csr_ell`` on the
whole graph and, at each threshold the scorer tries (and at lower ones,
whose dense parts walk more slots, for the fit), the hybrid call, its
K1 part (a call: the operand's pad to the block grid, then K1), its ELL
remainder, the pad alone and the sum of the two parts alone. Every time
is the mean of CUDA events over a run of calls, each measured twice in
turns. From them it fits, by least squares, the prices of
``ops/dispatch.KernelPrices`` in ns an operand column: the ELL
kernel's a stored entry and a row (t = a + c·nnz over the whole graph
and the remainders: c the entries', a the rows'), K1's a multiply-add of
its walk and of its deepest lane (K1 = the part less the pad, t =
max(walk, lane), on log t) and the pad's and sum's a byte. It prints the
constants for ``ops/dispatch`` and each candidate's predicted call
beside the measured one.

It then times, on gcn-ddi's graph (rcmk, F = 256), the ELL kernel on the
whole graph against K2 (``bsr_pallas``, the route the fill guard takes),
for the fill guard's re-derivation; and on the arxiv graph, with program
tracing on, builds ``spmm_plan(impl="auto", grad=True)`` as the train
cell does: the route (``sdb.route``: impl, pricing, the predicted costs),
one GCN request and one training step of the cells' widths, their
``sdb.kernel/csr_ell`` counts, and the answers and input gradients
against the plan's plain version.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import graphgen  # noqa: E402
from spmm_denseblock_tpu_torch.bench.timing import cuda_ms  # noqa: E402
from spmm_denseblock_tpu_torch.convert.divide import auto_threshold, divide  # noqa: E402
from spmm_denseblock_tpu_torch.formats.csr import CSR  # noqa: E402
from spmm_denseblock_tpu_torch.models.gnn import gcn_apply  # noqa: E402
from spmm_denseblock_tpu_torch.models.graph import sym_norm_adjacency  # noqa: E402
from spmm_denseblock_tpu_torch.models.train import make_train_step  # noqa: E402
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import f32_walk  # noqa: E402
from spmm_denseblock_tpu_torch.ops import dispatch as D  # noqa: E402
from spmm_denseblock_tpu_torch.ops.plan import run  # noqa: E402
from spmm_denseblock_tpu_torch.reorder import reorder  # noqa: E402
from spmm_denseblock_tpu_torch.utils import profiling  # noqa: E402

ITERS = 30
DEV = "cuda"
B = 128
# dense parts of more blocks than the scorer's candidates give: K1's slope
FIT_THRESHOLDS = (0.002, 0.005, 0.01)


def rel(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def graph_of(name: str) -> CSR:
    config = json.loads((ROOT / f"portbench/configs/{name}.json").read_text())
    n, edges = graphgen.load_edges(config["graph"])
    return sym_norm_adjacency(reorder(CSR.from_edges(edges, n_rows=n),
                                      config["ordering"])[0]), config


def timed(fns: dict) -> dict:
    """name -> ms of each fn, the mean of two runs in opposite orders."""
    times = {}
    for rep in range(2):
        for name in (list(fns) if rep == 0 else list(fns)[::-1]):
            times.setdefault(name, []).append(cuda_ms(fns[name], ITERS))
    return {k: float(np.mean(v)) for k, v in times.items()}


def fit(x, y):
    """(intercept, slope) of y = a + c·x by least squares."""
    A = np.stack([np.ones(len(x)), np.asarray(x, np.float64)], 1)
    (a, c), *_ = np.linalg.lstsq(A, np.asarray(y, np.float64), rcond=None)
    return float(a), float(c)


def fit_walk(walk, lane, t):
    """(cw, cd) of t = max(cw·walk, cd·lane), least squares on log t: a
    grid over decades, refined twice around its best point."""
    walk, lane, t = (np.asarray(v, np.float64) for v in (walk, lane, t))
    best = None
    cw0, cd0 = np.median(t / walk), np.median(t / lane)
    span = 3.0
    for _ in range(3):
        for cw in cw0 * np.logspace(-span, span, 61):
            for cd in cd0 * np.logspace(-span, span, 61):
                e = float(np.mean(np.log(np.maximum(cw * walk, cd * lane) / t) ** 2))
                if best is None or e < best[0]:
                    best = (e, cw, cd)
        _, cw0, cd0 = best
        span /= 10
    return best[1], best[2]


def calibrate(adj: CSR, record: dict) -> dict:
    n = adj.n_rows
    scored = sorted({*D._THRESHOLDS, auto_threshold(adj, B)})
    k_needed = -(-adj.n_cols // B) * B
    whole = D.spmm_plan(adj, impl="csr_ell", feat_dim=128, grad=False, device=DEV)
    parts = {}
    for t in sorted({*scored, *FIT_THRESHOLDS}):
        hyb = divide(adj, B, t)
        if hyb.dense.nnzb == 0:
            continue
        plan = D.spmm_plan(hyb, impl="hybrid", feat_dim=128, grad=False, device=DEV)
        k1 = plan.subplans[0]
        walk = f32_walk(hyb.dense.block_rows[: hyb.dense.nnzb], hyb.dense.n_block_rows)
        assert walk == (k1.positions // (B * B), k1.statics[6]), (t, walk)
        parts[t] = (plan, hyb.dense.nnzb, *walk, hyb.remainder.nnz)
    rows, per_col = [], {}
    rng = np.random.default_rng(7)
    for F in (128, 256):
        x = torch.as_tensor(rng.standard_normal((n, F)).astype(np.float32), device=DEV)
        want = whole(x)
        a, b = torch.empty_like(want), torch.empty_like(want)
        fns = {"csr_ell": lambda: whole(x),
               "pad": lambda: torch.nn.functional.pad(x, (0, 0, 0, k_needed - n)),
               "sum": lambda: a + b}
        for t, (plan, *_) in parts.items():
            err = rel(plan(x), want)
            assert err < 1e-5, (t, F, err)
            fns[f"hybrid {t}"] = functools.partial(plan, x)
            fns[f"k1 {t}"] = functools.partial(plan.subplans[0], x)
            fns[f"ell {t}"] = functools.partial(plan.subplans[1], x)
        ms = timed(fns)
        pad_ms = ms["pad"]
        ell_a, ell_c = fit([adj.nnz] + [p[4] for p in parts.values()],
                           [ms["csr_ell"]] + [ms[f"ell {t}"] for t in parts])
        # K1 alone: its call less the pad; the walk at F columns, the
        # deepest lane at min(F, MAX_BN)
        lane_cols = min(F, D.MAX_BN)
        cw, cd = fit_walk([p[2] * B * B * F for p in parts.values()],
                          [p[3] * B * B * lane_cols for p in parts.values()],
                          [ms[f"k1 {t}"] - pad_ms for t in parts])
        pad_bytes = 4 * F * (adj.n_cols + k_needed)
        sum_bytes = 12 * F * n
        per_col[F] = {
            "ns_per_entry": 1e6 * ell_c / F, "ns_per_row": 1e6 * ell_a / (n * F),
            "ns_per_block_mac": 1e6 * cw, "ns_per_lane_mac": 1e6 * cd,
            "ns_per_hybrid_byte": 1e6 * (pad_ms + ms["sum"]) / (pad_bytes + sum_bytes),
            "pad_ms": pad_ms, "sum_ms": ms["sum"]}
        for t, (plan, nnzb, slots, depth, rem) in parts.items():
            rows.append({"F": F, "thr": t, "scored": t in scored, "nnzb": nnzb,
                         "walked_slots": slots, "depth": depth, "remainder_nnz": rem,
                         "hybrid_ms": ms[f"hybrid {t}"], "k1_call_ms": ms[f"k1 {t}"],
                         "ell_ms": ms[f"ell {t}"]})
        rows.append({"F": F, "thr": None, "csr_ell_ms": ms["csr_ell"]})
        print(f"[probe] F={F}: csr_ell whole graph {ms['csr_ell']:.4f} ms; pad "
              f"{pad_ms:.4f}; sum {ms['sum']:.4f}; fit {per_col[F]}", flush=True)
        for t, (plan, nnzb, slots, depth, rem) in parts.items():
            print(f"[probe] F={F} thr={t}{' (scored)' if t in scored else ''}: "
                  f"{nnzb} blocks, {slots} walked slots, deepest lane {depth}, "
                  f"remainder {rem}: hybrid {ms[f'hybrid {t}']:.4f} ms = K1 call "
                  f"{ms[f'k1 {t}']:.4f} (pad included) + ELL {ms[f'ell {t}']:.4f} + sum",
                  flush=True)
        del x, a, b, want
    names = ("ns_per_entry", "ns_per_row", "ns_per_block_mac", "ns_per_lane_mac",
             "ns_per_hybrid_byte")
    prices = {k: float(f"{np.mean([per_col[F][k] for F in per_col]):.3g}") for k in names}
    record.update(widths=per_col, timings=rows, prices=prices, scored=scored)
    print("[probe] constants for ops/dispatch:", flush=True)
    for k, v in prices.items():
        print(f"[probe]   KERNEL_{k.upper()} = {v:.3g}", flush=True)
    # each candidate priced against its measured call
    for F in per_col:
        kp = D.KernelPrices(**prices, feat_dim=F)
        ell_ms = next(r["csr_ell_ms"] for r in rows if r["F"] == F and r["thr"] is None)
        print(f"[probe] F={F}: csr_ell predicted {kp.ell(adj.nnz, n) / 1e6:.4f} ms, "
              f"measured {ell_ms:.4f}", flush=True)
        for r in rows:
            if r["F"] == F and r["thr"] is not None:
                pred = kp.hybrid(r["remainder_nnz"], r["walked_slots"], r["depth"], B, n,
                                 adj.n_cols) / 1e6
                print(f"[probe] F={F}: hybrid thr={r['thr']} predicted {pred:.4f} ms, "
                      f"measured {r['hybrid_ms']:.4f}", flush=True)
    return prices


def ddi(record: dict) -> None:
    """The ELL kernel on gcn-ddi's whole graph against K2 at F = 256."""
    adj, _ = graph_of("gcn-ddi")
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (adj.n_rows, 256)).astype(np.float32), device=DEV)
    ell = D.spmm_plan(adj, impl="csr_ell", feat_dim=256, grad=False, device=DEV)
    k2 = D.spmm_plan(adj, impl="bsr_pallas", feat_dim=256, grad=False, device=DEV)
    route = D._auto_impl(adj, B, 256, {"device": DEV})[0]
    err = rel(ell(x), k2(x))
    assert err < 1e-5, err
    ms = timed({"csr_ell": lambda: ell(x), "bsr_pallas": lambda: k2(x)})
    record["ddi"] = {"n": adj.n_rows, "nnz": adj.nnz, "auto": route, "F": 256,
                     "rel_ell_vs_k2": err, **{f"{k}_ms": v for k, v in ms.items()}}
    print(f"[probe] ddi F=256 ({adj.nnz} nonzeros, auto routes to {route}): "
          f"csr_ell (ELL kernel) {ms['csr_ell']:.4f} ms, bsr_pallas (K2) "
          f"{ms['bsr_pallas']:.4f} ms; answers {err:.2e} apart", flush=True)


def route_check(adj: CSR, dims, record: dict) -> None:
    """auto with grad=True as the train cell builds it, program tracing
    on: the route, one request and one step's sdb.kernel/csr_ell counts,
    answers and input gradients against the plain version."""
    n = adj.n_rows
    prev = profiling.enable(True)
    try:
        profiling.take()
        plan = D.spmm_plan(adj, impl="auto", feat_dim=dims[0], grad=True, device=DEV)
        route = [s.attrs for s in profiling.take()["spans"] if s.name == "sdb.route"]
        g = torch.Generator(device=DEV).manual_seed(11)
        params = [{"w": torch.randn(a, b, device=DEV, generator=g) / a ** 0.5,
                   "b": torch.zeros(b, device=DEV)} for a, b in zip(dims[:-1], dims[1:])]
        x = torch.randn(n, dims[0], device=DEV, generator=g)
        with torch.no_grad():
            got = gcn_apply(params, plan, x)
            want = gcn_apply(params, lambda h: run(plan, h, plain=True), x)
        torch.cuda.synchronize()
        request = profiling.take()["counts"].get("sdb.kernel/csr_ell", 0)
        labels = torch.randint(0, dims[-1], (n,), device=DEV, generator=g)
        mask = torch.rand(n, device=DEV, generator=g) < 0.5
        step, init = make_train_step(gcn_apply, plan,
                                     functools.partial(torch.optim.Adam, lr=0.01))
        trained = [{k: v.clone() for k, v in p.items()} for p in params]
        opt = init(trained)
        profiling.take()
        step(trained, opt, x, labels, mask)
        torch.cuda.synchronize()
        train = profiling.take()["counts"].get("sdb.kernel/csr_ell", 0)
    finally:
        profiling.enable(prev)
    # A's and Aᵀ's SpMMs against their plain versions, the backward's too
    h = torch.randn(n, dims[1], device=DEV, generator=g, requires_grad=True)
    gy = torch.randn(n, dims[1], device=DEV, generator=g)
    (plan(h) * gy).sum().backward()
    grad, h.grad = h.grad.clone(), None
    (run(plan, h, plain=True) * gy).sum().backward()
    record["route"] = {"sdb.route": route, "impl": route[0]["impl"] if route else None,
                       "request_csr_ell_kernel_calls": request,
                       "step_csr_ell_kernel_calls": train,
                       "request_rel_vs_plain": rel(got, want),
                       "grad_rel_vs_plain": rel(grad, h.grad)}
    print(f"[probe] auto on arxiv (grad=True): {route}; sdb.kernel/csr_ell "
          f"{request} a request, {train} a training step; request "
          f"{record['route']['request_rel_vs_plain']:.2e} and Aᵀ gradient "
          f"{record['route']['grad_rel_vs_plain']:.2e} from the plain version",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="build/route_probe.json")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    record = {"card": torch.cuda.get_device_name(0)}
    adj, config = graph_of("gcn-arxiv")
    record.update(n=adj.n_rows, nnz=adj.nnz)
    print(f"[probe] {record['card']}; arxiv {adj.n_rows} rows, {adj.nnz} nonzeros",
          flush=True)
    calibrate(adj, record)
    route_check(adj, config["dims"], record)
    ddi(record)
    path = ROOT / args.out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=1))
    print(f"[probe] written {path}", flush=True)


if __name__ == "__main__":
    main()
