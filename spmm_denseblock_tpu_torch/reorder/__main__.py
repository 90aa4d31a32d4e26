"""Reorder CLI (twin of ``spmm_denseblock_tpu/reorder/__main__.py``; the
reference's reorder_graph / rabbit_reorder drivers, reorder_graph.cc:26-49).

    python -m spmm_denseblock_tpu_torch.reorder ogbn-arxiv rcmk \
        [--scale 0.25] [--out tmp] [--block-sizes 16 32 64 128] \
        [--heatmap] [--heatmap-block 256]

Loads the graph (a dataset name, or an edge-list file), dumps its CSR in
the reference's text format, applies the strategy, dumps the reordered
CSR and the permutation, and prints the bandwidth, block and ELL-layout
metrics of both: the same lines and files as the JAX CLI, its ELL lines
without their time estimates at TPU v5e gather rates.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="spmm_denseblock_tpu_torch.reorder")
    ap.add_argument("dataset", help="OGB name (synthetic fallback) or edge-list path")
    ap.add_argument("strategy")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", default="tmp")
    ap.add_argument("--block-sizes", type=int, nargs="*", default=[16, 32, 64, 128])
    ap.add_argument("--heatmap", action="store_true")
    ap.add_argument("--heatmap-block", type=int, default=256)
    ap.add_argument(
        "--ell-compact", action="store_true",
        help="also print the two-level gather's U/S and compacted spans "
             "(an O(nnz) unique pass)",
    )
    args = ap.parse_args(argv)

    from spmm_denseblock_tpu_torch.analyze.heatmap import (
        dump_heatmap,
        heatmap,
        plot_heatmap,
    )
    from spmm_denseblock_tpu_torch.analyze.metrics import (
        bandwidth_profile,
        block_metrics,
        ell_metrics,
    )
    from spmm_denseblock_tpu_torch.io.datasets import load_dataset
    from spmm_denseblock_tpu_torch.io.graph_io import (
        dump_csr,
        dump_permutation,
        load_edge_list,
    )
    from spmm_denseblock_tpu_torch.reorder import STRATEGIES, reorder

    if args.strategy not in STRATEGIES:
        print(f"unknown strategy {args.strategy}; have {sorted(STRATEGIES)}")
        return 2

    if os.path.exists(args.dataset):
        csr = load_edge_list(args.dataset)
        name = os.path.splitext(os.path.basename(args.dataset))[0]
    else:
        csr = load_dataset(args.dataset, scale=args.scale)
        name = f"{args.dataset.replace('-', '_')}_s{args.scale}"
    os.makedirs(args.out, exist_ok=True)
    print(f"{name}: n={csr.n_rows} nnz={csr.nnz}")

    def report(tag, g):
        dump_csr(g, os.path.join(args.out, f"{name}_{tag}"))
        bp = bandwidth_profile(g)
        print(
            f"-- {tag} --  bandwidth={int(bp['bandwidth'])} "
            f"profile={int(bp['profile'])} avg_span={bp['avg_span']:.1f}"
        )
        for b, m in block_metrics(g, args.block_sizes).items():
            print(
                f"  b={b:4d}: nnzb={int(m['nnzb']):9d} density={m['density']:.6f} "
                f"utilization={m['utilization']:.5f} avg={m['average']:.2f}"
            )
        em = ell_metrics(g, compact_model=args.ell_compact)
        print(
            f"  ell(quarter): slots={em['slots']} "
            f"padded_ratio={em['padded_ratio']:.3f} "
            f"classes={em['n_classes']} chunks={em['n_chunks']}"
        )
        if args.ell_compact:
            print(
                f"  ell compact: U/S={em['compact_u_over_s']:.3f} "
                f"spans={em['compact_spans']}"
            )
        if args.heatmap:
            h = heatmap(g, args.heatmap_block)
            dump_heatmap(h, os.path.join(args.out, f"{name}_{tag}_heatmap.txt"))
            plot_heatmap(h, os.path.join(args.out, f"{name}_{tag}_heatmap.png"))

    report("original", csr)
    t0 = time.perf_counter()
    rcsr, old2new = reorder(csr, args.strategy)
    print(f"{args.strategy}: {time.perf_counter() - t0:.2f}s")
    dump_permutation(old2new, os.path.join(args.out, f"{name}_{args.strategy}.txt"))
    report(args.strategy, rcsr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
