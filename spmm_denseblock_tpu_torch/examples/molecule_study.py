"""ogbg-style molecule study (twin of ``examples/molecule_study.py``):
per-graph reorder, the average block utilization table, then the
block-diagonal GIN graph classifier on the reordered batch.

Reference parity: ogbg_code_rcmk.py:60-76 (the 100-graph average
utilization under per-graph RCM) and ogbg_molhiv.py:5-59 (the
per-molecule greedy chain). The table is host analytics; the classifier
trains on the card unless given --device cpu.

    python -m spmm_denseblock_tpu_torch.examples.molecule_study [--n-graphs 100]
        [--train] [--device cpu] [--out build/molecule_study/ogbg_molecule_study.jsonl]

Appends the utilization table to --out (under build/ by default).
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-graphs", type=int, default=100)
    ap.add_argument("--mean-nodes", type=int, default=25)
    ap.add_argument("--train", action="store_true",
                    help="also train the block-diagonal classifier briefly")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the classifier trains (default: the card)")
    ap.add_argument("--out", default="build/molecule_study/ogbg_molecule_study.jsonl")
    args = ap.parse_args(argv)

    from spmm_denseblock_tpu_torch.analyze import molecule_utilization_study
    from spmm_denseblock_tpu_torch.io.datasets import synthetic_molecules

    csr, graph_ids = synthetic_molecules(n_graphs=args.n_graphs,
                                         mean_nodes=args.mean_nodes, seed=1234)
    table = molecule_utilization_study(csr, graph_ids,
                                       strategies=("original", "rcmk", "closest"),
                                       n_graphs=args.n_graphs)
    print(f"{args.n_graphs}-graph average block utilization "
          f"(molecule batch, {csr.n_rows} nodes / {csr.nnz} nnz):")
    bs = sorted(next(iter(table.values())).keys())
    print("strategy   " + "  ".join(f"b={b:<4}" for b in bs))
    for strat, row in table.items():
        print(f"{strat:<10} " + "  ".join(f"{row[b]['utilization']:.4f}" for b in bs))

    rec = {"kind": "molecule_utilization_study", "n_graphs": args.n_graphs,
           "mean_nodes": args.mean_nodes, "n": int(csr.n_rows), "nnz": int(csr.nnz),
           "table": {s: {str(b): v for b, v in row.items()} for s, row in table.items()}}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print("wrote", args.out)
    if not args.train:
        return rec

    # the classifier on the per-graph-reordered batch (graph_ids hold:
    # each graph reorders within its own range)
    import numpy as np
    import torch

    from spmm_denseblock_tpu_torch.analyze import per_graph_reorder
    from spmm_denseblock_tpu_torch.models import (
        graph_classifier_apply,
        init_graph_classifier,
        tree_leaves,
    )
    from spmm_denseblock_tpu_torch.ops import spmm_plan
    from spmm_denseblock_tpu_torch.ops._device import resolve_device
    from spmm_denseblock_tpu_torch.reorder import permutate

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    rcsr = permutate(per_graph_reorder(csr, graph_ids, "rcmk"), csr)
    n_graphs = int(graph_ids.max()) + 1
    dims = [8, 16, 16]
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((csr.n_rows, dims[0])).astype(np.float32),
                        device=dev)
    y = torch.as_tensor(rng.integers(0, 2, size=n_graphs), device=dev)
    params = init_graph_classifier(dims, 2, torch.Generator().manual_seed(0), device=dev)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    spmm = spmm_plan(rcsr, impl="csr_ell", device=dev)
    gids = torch.as_tensor(np.asarray(graph_ids), device=dev)
    opt = torch.optim.Adam(leaves, lr=1e-2)
    for _ in range(20):
        opt.zero_grad(set_to_none=True)
        logits = graph_classifier_apply(params, spmm, x, gids, n_graphs)
        loss = -torch.log_softmax(logits, -1).gather(1, y[:, None]).mean()
        loss.backward()
        opt.step()
    print(f"classifier 20 steps: loss {loss.item():.4f}")
    rec["classifier_loss"] = loss.item()
    return rec


if __name__ == "__main__":
    main()
