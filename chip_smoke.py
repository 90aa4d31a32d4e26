#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spmm_denseblock_tpu_torch) on one NVIDIA
GPU: builds the CUDA kernels from this checkout, holds each against its
plain PyTorch version, serves a GCN on the ogbl-ddi stand-in through the
BSR SpMM plan in f32, bf16 and int8 and through the CSR plan (K10),
trains it in f32 and in bf16x3 (precision="high") through the BSR plan
and in f32 through the CSR plan, runs the plans at bench.py's op shape
and the CSR kernel at the reference's test_csrmm shape, asks the
reference's question (does reordering make BSR beat CSR?) on the
ogbn-arxiv stand-in at its published size, and serves OGB's arxiv GCN
there through spmm_plan's CSR routes (impl="auto", the hybrid and ELL
tiers, int8 and bf16), then serves the rest of the model family at
published widths (GraphSAGE on ddi and arxiv, the GIN graph classifier
on a molecule batch, GAT on arxiv) and runs the ops beside SpMM (the
dense-block GEMM, SDDMM, CSR -> BSR on the card), then drives the
package's bench harness, its sweep CLI, spmm_tune and the profiler, and
runs the one-bf16-pass kernels of precision="default".

    python3 chip_smoke.py

Phases:
  1. set-up   torch/CUDA versions, the card's name and power limit, TF32 off
  2. build    nvcc builds each csrc/*.cu into build/kernels/, all at once
              (timed)
  3. kernels  K1 (flat), K2 (sorted), K4 (row groups) and K5 (resident),
              each in f32 and in bf16 on the tensor cores, K3 (bf16x3 on
              the sorted, flat and resident layouts), and the int8 K6
              (flat), K7 (sorted; group-scale
              and per-slot scales), K8 (row groups) and K9 (resident,
              resident=True with f_tile=128), each against its plain
              version at a ragged small shape, a 7-block-row shape
              (phantom and absent lanes) at b = 32 and at b = 128 with a
              ragged F (the f32 kernels' pipelined FFMA loop on a padded
              operand) and the ddi shape; K10 (CSR, on
              the band layout) against its plain version at a ragged CSR
              with empty head rows and an empty band (F=7), a rectangular
              one (F=64) and ddi (F=256); then each K3 instance and its
              exact kernel (K2, K1, K5) on an input whose sums are exact in
              f32 (bf16x3_exact_case at b = 16, 32, 64 and 128, F=200): K3 must
              give A_hi X_hi + A_hi X_lo + A_lo X_hi and the exact kernel A
              X, each bit for bit (the two differ in most entries), and each
              K3 call split its operand once, and f32 K4 A X bit for bit
              too; then the bf16 K1, K2, K4 and K5
              entries at b = 16, 32, 64 and 128 and F = 70 and 256 on an
              input whose sums are exact in f32 (bf16_exact_case): each
              must equal float64 bit for bit; then K7 (both scale modes),
              K8, K6 and K9 at b = 16 and 32 (the small-block int8
              tensor-core loop) and 64 and 128 (the int8 tensor-core
              ring) and F = 70 and 256 on 37 block-rows of
              int8_exact_case, where nothing rounds before the column
              scale: each must equal float64 bit for bit
  4. slice    GCN [256, 256, 256] on load_dataset("ogbl-ddi") (rcmk,
              sym_norm_adjacency, spmm_plan(impl="bsr_pallas", b=128)),
              4 seeded requests in f32 (K2), each checked against a float64
              host reference at 1e-4; then the same requests through
              spmm_plan(..., dtype=torch.int8) (bsr_int8_pallas, K7 on
              an operand made by quantize_int8, one launch a SpMM), each
              answer within 6e-2 of the float64 reference and each SpMM
              within 1e-5 of its plain version; then the same requests
              through spmm_plan(adj, impl="csr_pallas") (K10), each within
              1e-4 of the float64 reference; then the same requests in
              bf16 (spmm_plan(..., dtype=torch.bfloat16), bf16 K2 on the
              tensor cores), each SpMM within 1e-5 of its plain version
              and each answer within 3e-2 of the float64 reference
  5. train    the same model and graph, trained through spmm_plan's
              default grad plan (K2 on A and on Aᵀ), seeded labels over
              256 classes and a 60% train mask: 5 Adam(lr=1e-2) steps of
              make_train_step in f32, then 5 with precision="high" (K3 on
              the sorted layout, both ways, each call with its operand
              split), then 5 through the csr_pallas
              grad plan (K10 on A and on Aᵀ). Step 0's parameter gradients
              within 1e-4 (max |err| / max |ref|) of a float64 host
              autograd reference on the dense A, taken at the kernel
              run's ReLU pattern (a pre-activation within rounding of 0
              flips sign and moves the gradient by far more than the
              rounding); the hidden pre-activations whose sign differs
              from float64's at most FLIP_CAP (0 in f32, 16 in "high"),
              each within 2^-16 max |z| of 0; the loss after the 5
              steps below step 0's; 2 forward and 1 backward SpMM launch
              per step
  6. op       random_bsr(2e-2, 1024, 1024, b=128, seed=1234), F=512: f32
              default (K2), depth_sort=False (K1), row groups packed as
              the bf16 plan packs them (f32 K4: no plan routes f32
              there), precision="high" (K3
              sorted), "high" with depth_sort=False (K3 flat), "high" with
              resident=True, depth_sort=False (K3 resident),
              resident=True, depth_sort=False (K5); bf16 default (K2),
              depth_sort=False (K4), resident=False (K1) and
              precision="high", resident=True (K5); int8 with
              calibration=dense[:4096] as bench.py: default (K7),
              depth_sort=False (K8), resident=False (K6) and
              resident=True, f_tile=128 (K9); each against its plain
              version, each int8 answer within 6e-2 of f32 K2's; the bf16
              K1, K2, K4 and K5 entries on the op shape's blocks with
              small integer values (every sum exact in f32), bit for bit
              against their plain versions;
              K3's operand split against its plain version, bit for bit;
              the int8 operand's quantization (quantize_int8, dynamic and
              static, (N, F) and transposed, there also with a NaN, a
              +Inf and a -Inf column, and at the int8 slice's ddi
              operand with dynamic scales and pad rows) against its plain
              version, bit for bit, and the NaN and +-Inf entries as JAX
              quantizes them (0; static +-127; 0 in a dynamic column of
              scale Inf);
              bench.py's bf16x3 self-check (the "high" answer within 1e-4
              of exact f32 K2's and of the bsr_xla tier's); K10 at the
              reference's test_csrmm shape, random_csr(2e-3, 2^17,
              seed=1234) with F=512 (column strips of csr_strip_width's
              width), against its plain version and within 1e-4 of the
              csr_xla tier's answer
  7. reorder  load_dataset("ogbn-arxiv") at scale 1.0 (169,343 nodes),
              with graph_stats and dataset_provenance; under original,
              rcmk, rabbit and gorder (the native engine; rcmk bit for bit
              against its numpy body, each permutation checked) its host
              seconds, block_metrics at b = 16, 32, 64 and 128 and
              bandwidth_profile; spmm_plan(impl="csr_pallas") (K10) on
              each ordering at F=128 (X: seeded signs of 0.5, the
              reference's check_result operand, every sum exact in f32)
              against its plain version and within 1e-4 of spmm_scipy;
              spmm_plan(impl="bsr_pallas") on the ordering with the fewest
              32 x 32 blocks: f32 K2 at block_size=32 and 16 and K1
              (depth_sort=False) at 32, the pipelined FFMA loop's small
              instances, bf16 K2 and K3 (precision="high", sorted) at
              32 and 16, the small-block tensor-core loop, and int8 K7
              (dtype=torch.int8) at 32 and 16, the small-block int8
              tensor-core loop, each against its plain version and
              within 1e-4 (int8: 6e-2 of max |ref|) of spmm_scipy; after its
              counts are read, the same plans on a standard-normal X,
              against their plain versions and (but for bf16) a float64
              scipy product (int8 at 6e-2); then their CUDA-event times
              (K10 on each ordering; each BSR plan with its slots,
              deepest lane and F tile width, then freed; int8 on an
              operand quantized beforehand, the whole call beside it; the
              CSR / BSR ratio at b = 32) beside plain, bound and library;
              once, off the path, bf16 K1 (resident=False) and K4
              (depth_sort=False), K3 on K1's layout and int8 K6
              (resident=False) at b = 32, each checked against its plain
              version and timed the same way; its device memory freed
              before phase 8
  8. serve    OGB's ogbn-arxiv GCN baseline at full width ([128, 256,
              256, 40]; seeded weights) on the reorder phase's graph with
              the fewest blocks (gorder) and on the original ordering,
              sym_norm_adjacency: the route impl="auto" takes on each
              (the JAX router's: the fill guard, then over the 4 GiB
              budget the threshold scorer, on the card pricing an f32
              plan by the kernels it runs; its report is printed), which
              must be csr_ell on both (the ELL kernel on the whole
              graph), then
              4 seeded requests through spmm_plan with impl="auto" on
              both orderings, "hybrid" (the dense blocks through the BSR
              kernel plan the gate picks, the rest through the ELL
              tier), "hybrid" with dtype=torch.int8 (the int8 kernel
              plan, its operand and the int8 ELL's quantized by
              quantize_int8), "csr_ell" in bf16 and "csr_pallas" (K10),
              each request within 1e-4 (int8 6e-2, bf16 3e-2) of a
              float64 host reference, each SpMM's kernels (a hybrid's
              dense part and its f32 ELL remainder, the ELL kernel of
              "auto"'s all-ELL route, K10) within 1e-5 of their plain
              versions; then at F = 128 on the
              check_result operand csr_ell (compact="force"),
              csr_ell_banded (band_rows=2^15), csr_ell_int8 (dynamic and
              calibrated), windowed, windowed_int8 and tiered, each
              within 1e-4 of spmm_scipy (int8 6e-2 of max |ref|)
  8b. models the model family at published widths, each request against
              a float64 reference (f32 1e-4, int8 6e-2, bf16 3e-2; SAGE
              and GIN on the host in numpy, GAT the same function in
              float64 on the card), every kernel SpMM within 1e-5 of its
              plain version: GraphSAGE [256, 256, 256] (OGB's ogbl-ddi
              --use_sage) on ddi's mean_adjacency through bsr_pallas f32
              (K2), int8 (K7, quantize_int8) and csr_pallas (K10), 4
              requests each, then one Adam step through the f32 grad plan
              (K2 on A and Aᵀ), its step-0 gradients within 1e-5 of the
              plain plan's at the kernel run's ReLU pattern and its loss
              falling; GraphSAGE [128, 256, 256, 40] (OGB's ogbn-arxiv
              --use_sage) on the serve phase's graph's mean_adjacency
              through impl="auto" (route and scorer's report printed); the
              GIN graph classifier [300] x 6, 2 classes (OGB's mol
              main_pyg.py --gnn gin --emb_dim 300 --num_layer 5) on
              synthetic_molecules(4113, 25) under per-graph rcmk, the raw
              adjacency, through csr_ell, bsr_pallas at b = 32 (K1) and
              auto; GAT [128, 250, 250, 40], 3 heads (DGL's ogbn-arxiv
              gat.py widths) on the serve phase's graph's attention
              pattern (gat_pattern: bidirected, a self-loop on every
              node), under inference_mode through its pattern plan
              (spmm_plan(values="call"): the ELL kernel with each
              layer's attention values, every valued call within 1e-5 of
              its plain version), its peak device memory; then
              dense_block_gemm at bench.py's op shape (the block list
              shuffled) within 1e-5 of f32 K2, SDDMM's element tier on
              arxiv (d = 128) and its block tier on ddi's 1,156 blocks (d
              = 256, f32 and bf16: f32 scores), csr_to_bsr_on_device on
              arxiv at b = 32: its count and its blocks equal to the host
              conversion's bit for bit, and with nnzb_max 1,000 below the
              count the dropped-block contract
  8c. bench  the package's bench harness, tuner and profiler
              (spmm_denseblock_tpu_torch.bench, ops.spmm_tune,
              utils.trace): bench_synthetic_bsr at bench.py's op shape
              (p = 2e-2, b = 128, F = 512; K2) at transb 0 and 1, each
              record's ms within 10% of cuda_ms on the same plan and
              operand (the f32 op plan; the operand_layout="col" plan on
              B^T) and its GFLOP/s 2*nnzb*b^2*F / t; the op plan's answer
              on its first 8 block-rows within 1e-4 of spmm_scipy
              (conformance_fields), and the column-major plan's answer
              equal to the row plan's bit for bit; the sweep CLI's quick
              grids (bsrmm, csrmm, graph) in this process, every record
              free of errors and one a case; bench_graph on the arxiv
              stand-in under rcmk, b = 128, F = 128, through hybrid and
              csr_pallas; bench_train_step at its defaults (arxiv, rabbit,
              [128, 256, 40], auto); spmm_tune on arxiv's
              sym_norm_adjacency under rcmk at F = 128 with the JAX
              package's candidates and csr_pallas, at b = 128 and 32 (a
              bsr candidate whose f32 blocks pass auto's 4 GiB guard is
              not built), no error but out-of-memory, the winner within
              1e-4 of spmm_scipy, beside auto's route; auto with tune_with=
              on the serve graph (gorder, b = 128, a 1 GiB budget), where
              the scorer's best hybrid and pure ELL lie within 15% (under
              the card's kernel pricing the hybrid at auto_threshold,
              whose dense part is empty, ties pure ELL): both finalists
              timed, the tuned plan within 1e-4 of spmm_scipy;
              a torch.profiler trace of one op-shape call, which must
              name the K2 entry sdb_bsr_spmm_sorted, and the op record's
              roofline share against the H100 peaks, at most 1.05
  9. timing   CUDA-event times of kernel, plain and library paths
              (library: one PyTorch call computing the same function,
              timed as a yardstick and never called by the port:
              torch.sparse_bsr_tensor @ X for the f32 and bf16 BSR
              kernels, torch.sparse_csr_tensor @ X for K10, none for
              int8), GFLOP/s = 2*nnzb*b^2*F / t (real blocks) or
              2*nnz*F / t (CSR); ms per request and per training step, BSR
              and CSR on the same card; the int8 operand's quantization
              (dynamic and static) apart from its kernel, and the bf16
              kernels on the bf16 operand (as the library call gets it)
              apart from the whole call that casts the f32 one (each
              the mean of two runs, in the order kernel, whole, whole,
              kernel); each
              kernel's bound (the larger of its bytes, each input read
              once and each output written once, over 3.35 TB/s, and its
              operations over the peak of their type); K3's operand split
              alone (its own row; the K3 rows time whole calls, the split
              included); which tier bench.py would make its headline (the
              faster of exact f32 K2 and K3, the self-check having passed);
              the rows of the tensor-core loop (bf16 entries, K3), of
              the exact-f32 kernels' pipelined loop (K1, K2, K4, K5) and
              of the int8 ring (K6-K9) carry their F tile width (bn), the
              f32 rows their slot count (zero pads included); the
              int8 rows time the ring alone
              on an operand quantized transposed beforehand and the whole
              call (quantize_int8 included), in the order ring, whole,
              whole, ring; the quantization kernel, dynamic and static,
              beside its plain version and its bound (the operand read
              once; with dynamic scales also the time of the two passes'
              bytes), and PyTorch's transposed copy alone; the int8 ddi SpMM call
              in its parts; first, the serve phase's times: ms per
              request of each route beside the csr_pallas (K10) request,
              ms per SpMM at F = 128 of csr_ell, hybrid, hybrid int8 and
              windowed beside K10, torch.sparse_csr_tensor @ X and the
              CSR bytes bound, a csr_ell SpMM and an "auto" request under
              torch.profiler, the hybrids' dense-part kernels beside
              their plain versions, bounds and library calls, and the ELL
              kernel (K11) on the f32 hybrid's remainder at F = 128 and
              256, held to its plain version (the torch-op chunk loop)
              and timed beside it, its CSR bytes bound and
              torch.sparse_csr_tensor @ X (cuSPARSE); then the
              models phase's: ms per request of each model and route,
              dense_block_gemm beside f32 K2 and its bound, SDDMM (both
              tiers) beside its bound and torch.sparse.sampled_addmm,
              csr_to_bsr_on_device on the card beside the whole call and
              the host conversion, a GAT request under torch.profiler,
              the ELL kernel with call values (3 heads) at F = 750 and
              120 on the GAT's pattern beside its plain version, its
              bytes bound (values 4 x 3 bytes an entry) and cuSPARSE on
              each head, and K1 at b = 32 on the molecule batch; last, each
              slice's request under torch.profiler: the card's busy
              share and device time by kernel

  10. dist     the distributed layer (parallel/), after every other
              timing: (a) one rank over NCCL in this process at the op
              shape, allgather and ring with f32 K2 stripes, each against
              its plain version and spmm_scipy's first block-rows, timed
              beside the single-card K2 plan; (b)-(f) four ranks spawned
              over gloo, all on the one GPU (exchanges through the
              host): the op shape in f32, bf16, "high" and int8
              (calibrated and dynamic) on allgather and ring, f32 on the
              xla local impl and on the (2, 2) mesh with the feature
              axis, the quick bsrmm grid's matrix (K1, K4, K8), halo on
              a banded BSR and contiguous balancing on a graded one, LPT
              on the arxiv stand-in under gorder at b = 32, the ddi GCN
              request in f32 and int8 with each rank's output stripe fed
              to the next layer, the arxiv GCN request through the
              hybrid (gorder) and csr_ell (original), the windowed tier
              and SDDMM; each rank checks its launches (allgather 1,
              ring 4, halo 3 a call, quantize_int8 1 a call for int8),
              its stripe against the routers' plain versions
              (KERNEL_TOL) and the gathered C against spmm_scipy at the
              tier's gate; here the GCN, windowed and SDDMM answers
              against single-card plans on the same inputs. Prints the
              transport, plan seconds, ms a call per rank (four ranks
              share one card: not scaling numbers) and the exchange's
              bytes beside comms_bytes_per_device, then a {"dist": ...}
              JSON line before the card line
  11. train-dist distributed training (parallel/train.py, the xla local
              product: no kernel launches), after phase 10: (a) one rank
              over NCCL in this process, the ddi GCN [256, 256, 256]
              through make_dist_train_step (allgather) and the
              single-card step on the bsr_xla plan from the same weights,
              both with torch's deterministic algorithms: 3 Adam steps
              each, losses and parameters within 1e-4, step 0's gradients
              within 1e-4 of float64 at the run's ReLU pattern; phase 5's
              f32 step (K2) from the same weights beside it, its distance
              printed and its time beside the dist step's; (b) four ranks
              over gloo sharing the card: the ddi GCN on (4, 1)
              allgather and ring and on
              (2, 2) with the feature axis, SAGE (mean_adjacency) and GIN
              (sym_norm_adjacency) at its widths on (2, 2), OGB's arxiv
              GCN [128, 256, 256, 40] on the serve phase's gorder hybrid on
              (4, 1): 3 steps each from weights made here, the loss equal
              on every rank and falling, the gathered step-0 gradients
              within 1e-4 of float64 (the sparse A on the host) at the
              run's ReLU pattern (each ReLU input's sign that differs from
              float64's within 2^-16 of max |z64| of 0), ms a step per
              rank and the bytes received forward, backward and in the
              gradient sums beside comms_bytes_per_device's reckoning of
              the SpMM exchanges, no kernel launched; (c) the same world
              saves the (2, 2) GCN after step 2 (models/checkpoint_dist),
              restores into fresh templates and takes step 3 bit-equal to
              the uninterrupted one (torch's deterministic algorithms),
              bytes written per rank beside its shards, seconds per save
              and restore; (d) dryrun_multichip(4), whole, its last pass
              the readiness harness (bench/readiness.py: halo, f32, worlds
              of 1 and 4 ranks); (e) bench_train_scaling and bench_scaling
              over worlds of 1 and 2 ranks at a small shape (TD_SCALING:
              JAX's default grid took 120.5 s); (f) the dist_train
              example, 2 epochs, then resumed from its checkpoint. A
              {"train_dist": ...} JSON line follows the dist line

  8d. default precision="default", the TPU's one bf16 pass (after bench,
              on the main path; its times right after the models
              phase's): bf16 K1 and K5 (resident=True) at bench.py's op
              shape, K1 at b = 32 on the reorder phase's arxiv graph
              (gorder, F = 128), K10's one-bf16-pass kernel
              (sdb_csr_spmm_bf16) at the op csr shape (F = 512), at ddi
              (F = 256), on the serve phase's graph and on the arxiv
              graph under each ordering (F = 128), each with its strips,
              lanes a nonzero and segments a warp: each launching its entry,
              within 1e-5 of its plain version and 3e-2 of float64 on
              seeded normal X; then bf16_exact_case at each BSR plan's b
              and F and each K10 graph with integer values and operand,
              bit for bit against float64; each whole call (the operand's
              cast included) timed beside its bound (bf16 bytes and
              operations) and the library call (bf16 sparse_bsr @ X;
              sparse_csr @ X in bf16 where PyTorch runs it, else f32),
              and the serve call's device busy share (torch.profiler)

The main path is phases 4 to 8d, each of their runs (f32 slice, int8
slice, CSR slice, bf16 slice, f32 training, "high" training, CSR
training, op, reorder, serve, each configuration of models, bench and
default) with the launch counts set to 0 just before it and read just
after; every kernel of the path must have run there, and the bench run
must have launched K2, K1 and K10. Every phase's seconds by the
script's own clock are logged ("[phase] ..." lines) and summed up in the
"[done]" line. Prints the kernels' JSON line, then the last line {"ok":
true, "device": {...}}. Any failure raises and exits non-zero; there is
no CPU path.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from spmm_denseblock_tpu_torch.bench import (  # noqa: E402
    bench_graph,
    bench_synthetic_bsr,
    bench_train_step,
    sweeps,
)
from spmm_denseblock_tpu_torch.bench.harness import conformance_fields  # noqa: E402
from spmm_denseblock_tpu_torch.bench.timing import cuda_ms  # noqa: E402
from spmm_denseblock_tpu_torch.convert.csr2bsr import bsr_to_csr, csr_to_bsr  # noqa: E402
from spmm_denseblock_tpu_torch.formats.bsr import BSR, random_bsr  # noqa: E402
from spmm_denseblock_tpu_torch.formats.csr import CSR, random_csr  # noqa: E402
from spmm_denseblock_tpu_torch.formats.windowed import divide_windowed  # noqa: E402
from spmm_denseblock_tpu_torch.analyze.metrics import (  # noqa: E402
    bandwidth_profile,
    block_metrics,
    calculate_nnzb,
)
from spmm_denseblock_tpu_torch.io.datasets import (  # noqa: E402
    dataset_provenance,
    graph_stats,
    load_dataset,
)
from spmm_denseblock_tpu_torch.analyze.molecules import per_graph_reorder  # noqa: E402
from spmm_denseblock_tpu_torch.io.datasets import synthetic_molecules  # noqa: E402
from spmm_denseblock_tpu_torch.models.gnn import linear  # noqa: E402
from spmm_denseblock_tpu_torch.models.graph import gat_pattern  # noqa: E402
from spmm_denseblock_tpu_torch.models import (  # noqa: E402
    GAT,
    GCN,
    SAGE,
    GraphClassifier,
    gcn_apply,
    init_gcn,
    init_sage,
    make_eval_step,
    make_gat_apply,
    make_train_step,
    masked_cross_entropy,
    mean_adjacency,
    sage_apply,
    sym_norm_adjacency,
    tree_leaves,
    tree_map,
)
from spmm_denseblock_tpu_torch.ops import (  # noqa: E402
    _kernels,
    bsr_spmm_xla_plan,
    count_nnzb_device,
    csr_to_bsr_device,
    csr_to_bsr_on_device,
    dense_block_gemm,
    sddmm_block_plan,
    sddmm_plan,
    spmm_plan,
)
from spmm_denseblock_tpu_torch.ops.bsr_spmm_int8 import quantize_per_column  # noqa: E402
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import (  # noqa: E402
    _auto_group_pow2,
    _ensure_covering,
    _pack_rowgroups,
    _pallas_apply,
    _rowgroup_policy,
    _sm_count,
    bf16_small_geometry,
    bf16_tile_geometry,
    bsr_spmm_pallas_plan,
    f32_small_geometry,
    group_pointer,
    lane_order,
    plain_apply,
    split_operand,
    split_operand_plain,
    tile_geometry,
)
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas_int8 import (  # noqa: E402
    _int8_pallas_apply,
    bsr_spmm_pallas_int8_plan,
    int8_tile_bn,
    quantize_int8,
    quantize_int8_plain,
    quantize_operand,
    run_quantized,
    transpose_operand,
)
from spmm_denseblock_tpu_torch.ops.csr_spmm import csr_spmm_plan  # noqa: E402
from spmm_denseblock_tpu_torch.ops.csr_spmm_ell import (  # noqa: E402
    _ell_apply,
    _ell_int8_apply,
    ell_strip_width,
)
from spmm_denseblock_tpu_torch.ops.dispatch import (  # noqa: E402
    _auto_impl,
    _explicit_hybrid,
    _thin_margin_finalists,
    spmm_tune,
)
from spmm_denseblock_tpu_torch.ops.csr_spmm_pallas import (  # noqa: E402
    CSR_BF16_MAX_STRIP,
    SEGMENT_NNZ,
    _csr_pallas_apply,
    _l2_bytes,
    csr_bf16_strip_width,
    csr_spmm_pallas_plan,
    csr_strip_width,
)
from spmm_denseblock_tpu_torch.ops.plan import Plan, _sum_apply  # noqa: E402
from spmm_denseblock_tpu_torch.ops.plan import run as plan_run  # noqa: E402
from spmm_denseblock_tpu_torch.parallel.spmm import (  # noqa: E402
    layout_tag,
    plan_strategy,
    strategy_of,
)
from spmm_denseblock_tpu_torch.ops.windowed_spmm import (  # noqa: E402
    _windowed_apply,
    _windowed_int8_apply,
)
from spmm_denseblock_tpu_torch.ops.reference import (  # noqa: E402
    CHECK_EPS,
    assert_allclose,
    bf16_exact_case,
    bf16x3_exact_case,
    int8_exact_case,
    spmm_scipy,
)
from spmm_denseblock_tpu_torch.reorder import (  # noqa: E402
    STRATEGIES,
    check_permutation,
    permutate,
    rcm_variant,
    reorder,
)
from spmm_denseblock_tpu_torch.utils import device_info, roofline, trace  # noqa: E402
from spmm_denseblock_tpu_torch.utils.profiling import (  # noqa: E402
    HBM_BYTES_S,
    PEAK_OPS_S,
)

KERNEL_TOL = 1e-5  # kernel vs plain version, relative to max |plain|
INT8_TOL = 6e-2    # int8 answer vs f32/f64 reference, relative to max |ref|
BF16_TOL = 3e-2    # bf16 answer vs f64 reference, relative to max |ref|
GRAD_TOL = 1e-4    # step-0 gradients vs float64, relative to max |ref|
BF16X3_TOL = 1e-4  # bench.py's gate for the bf16x3 answer vs exact f32
# hidden pre-activations whose sign differs from float64's, per training
# run, and how far from 0 (relative to max |z|) each may lie: bf16x3 moves
# a pre-activation by ~5e-6 of max |z|, exact f32 by far less
FLIP_CAP = {None: 0, "high": 16}
FLIP_REL = 2.0 ** -16
SEED = 1234
DEV = "cuda"
# the reorder phase: the reference's graph grid (original, rcmk, rabbit)
# plus gorder on the ogbn-arxiv stand-in at its published size, K10 on
# each ordering at the grid's widest dim, f32 K2 at b = 32 on one
REORDER_DATASET = "ogbn-arxiv"
REORDER_SCALE = 1.0
REORDER_ORDERINGS = ("original", "rcmk", "rabbit", "gorder")
REORDER_BLOCK_SIZES = (16, 32, 64, 128)
REORDER_B = 32
REORDER_F = 128
# the BSR plans of the reorder phase, on the ordering with the fewest
# REORDER_B blocks: (label, block size, plan arguments, kernel), f32 K2 at
# b = 32 first (the CSR / BSR ratio's), then f32 K2 at 16 and K1 at 32
# (the pipelined FFMA loop's small instances), then bf16 K2 and K3
# (sorted) at 32 and 16 (the small-block tensor-core loop), then int8 K7
# at 32 and 16 (the small-block int8 tensor-core loop)
REORDER_BSR = (("K2", 32, {}, "bsr_spmm_sorted"),
               ("K2", 16, {}, "bsr_spmm_sorted"),
               ("K1", 32, {"depth_sort": False}, "bsr_spmm_flat"),
               ("bf16 K2", 32, {"dtype": torch.bfloat16}, "bsr_spmm_sorted_bf16"),
               ("K3 sorted", 32, {"precision": "high"}, "bsr_spmm_sorted_bf16x3"),
               ("bf16 K2", 16, {"dtype": torch.bfloat16}, "bsr_spmm_sorted_bf16"),
               ("K3 sorted", 16, {"precision": "high"}, "bsr_spmm_sorted_bf16x3"),
               ("int8 K7", 32, {"dtype": torch.int8}, "bsr_spmm_int8_sorted"),
               ("int8 K7", 16, {"dtype": torch.int8}, "bsr_spmm_int8_sorted"))
# timed once after the phase (not on its path), at REORDER_B, each plan
# freed after its row: the walks that run the small-block tensor-core
# loops beside their targets (int8 K6: resident=False; depth_sort=False
# packs K8's row groups)
REORDER_ONCE = (
    ("bf16 K1", {"dtype": torch.bfloat16, "resident": False}, "bsr_spmm_flat_bf16"),
    ("bf16 K4", {"dtype": torch.bfloat16, "depth_sort": False},
     "bsr_spmm_rowgroup_bf16"),
    ("K3 flat", {"precision": "high", "depth_sort": False}, "bsr_spmm_flat_bf16x3"),
    ("int8 K6", {"dtype": torch.int8, "resident": False}, "bsr_spmm_int8_flat"))
# the serving phase: OGB's ogbn-arxiv GCN baseline at full width
# (examples/nodeproppred/arxiv/gnn.py in snap-stanford/ogb: 3 layers,
# hidden 256, 128 features, 40 classes) on the reorder phase's graphs,
# sym_norm_adjacency, SERVE_REQUESTS seeded requests through spmm_plan's
# CSR routes: (label, ordering, spmm_plan arguments, tolerance tag).
# "auto" on the fewest-block ordering and on the original one, the
# explicit hybrid in f32 and int8, bf16 ELL, and csr_pallas (K10) beside
# them
SERVE_DIMS = [128, 256, 256, 40]
SERVE_REQUESTS = 4
SERVE_ROUTES = (
    ("auto", "best", {"impl": "auto", "feat_dim": 128}, "f32"),
    ("auto original", "original", {"impl": "auto", "feat_dim": 128}, "f32"),
    ("hybrid", "best", {"impl": "hybrid"}, "f32"),
    ("hybrid int8", "best", {"impl": "hybrid", "dtype": torch.int8}, "int8"),
    ("csr_ell bf16", "best", {"impl": "csr_ell", "dtype": torch.bfloat16}, "bf16"),
    ("csr_pallas", "best", {"impl": "csr_pallas"}, "f32"),
)
# the ELL tiers at op level, on the fewest-block ordering at F = 128
SERVE_OPS = (
    ("csr_ell compact=force", {"impl": "csr_ell", "compact": "force"}),
    ("csr_ell_banded 2^15", {"impl": "csr_ell_banded", "band_rows": 1 << 15}),
    ("csr_ell_int8 dynamic", {"impl": "csr_ell", "dtype": torch.int8}),
    ("csr_ell_int8 calibrated", {"impl": "csr_ell", "dtype": torch.int8,
                                 "calibration": True}),
    ("windowed", {"impl": "windowed"}),
    ("windowed_int8", {"impl": "windowed", "dtype": torch.int8}),
    ("tiered", {"impl": "tiered"}),
)
# the SpMMs timed at F = 128 beside K10 (their serving plans, or op plans)
SERVE_TIMED = ("csr_ell", "hybrid", "hybrid int8", "windowed", "csr_pallas")
# the widths of the ELL kernel's rows (K11, on the f32 hybrid's remainder)
ELL_ROW_F = (128, 256)
TOL_OF = {"f32": CHECK_EPS, "int8": INT8_TOL, "bf16": BF16_TOL}
# the models phase: each model of the family at a published width, through
# the ported kernels. SAGE as OGB's ogbl-ddi link-prediction encoder
# (examples/linkproppred/ddi/gnn.py --use_sage: hidden 256, 2 layers) on
# the slice's ddi graph, mean_adjacency, b = 128: (label, spmm_plan
# arguments, tolerance tag, kernel)
MODEL_REQUESTS = 4
MODEL_GRAD_TOL = 1e-5  # kernel vs plain plan step-0 gradients, a leaf
SAGE_DDI_DIMS = [256, 256, 256]
SAGE_DDI_ROUTES = (
    ("bsr_pallas f32", {"impl": "bsr_pallas", "block_size": 128}, "f32",
     "bsr_spmm_sorted"),
    ("bsr_pallas int8", {"impl": "bsr_pallas", "block_size": 128,
                         "dtype": torch.int8}, "int8", "bsr_spmm_int8_sorted"),
    ("csr_pallas", {"impl": "csr_pallas"}, "f32", "csr_spmm"),
)
# SAGE as OGB's ogbn-arxiv baseline (examples/nodeproppred/arxiv/gnn.py
# --use_sage: 3 layers, hidden 256) on the serve phase's graph, auto
SAGE_ARXIV_DIMS = [128, 256, 256, 40]
# the GIN graph classifier as OGB's molecule baseline (examples/
# graphproppred/mol/main_pyg.py --gnn gin --emb_dim 300 --num_layer 5) on
# a batch of ogbg-molhiv's test split's size (4,113 molecules of ~25
# atoms), per-graph rcmk, the raw adjacency: csr_ell (examples/
# molecule_study.py's route), bsr_pallas at b = 32 (K1) and auto
GIN_DIMS = [300] * 6
GIN_MOLECULES = (4113, 25)
GIN_ROUTES = (("csr_ell", {"impl": "csr_ell"}),
              ("bsr_pallas b=32", {"impl": "bsr_pallas", "block_size": 32}),
              ("auto", {"impl": "auto", "feat_dim": 300}))
# GAT at the widths of DGL's ogbn-arxiv example (examples/pytorch/ogb/
# ogbn-arxiv/gat.py --n-hidden 250 --n-heads 3 --n-layers 3) on the JAX
# package's GAT architecture (no residual), the serve phase's graph's
# attention pattern (gat_pattern)
GAT_DIMS = [128, 250, 250, 40]
GAT_HEADS = 3
SDDMM_ARXIV_D = 128  # the element tier on arxiv
SDDMM_DDI_D = 256    # the block tier on ddi's 1,156 blocks of 128
CONVERT_B = 32       # csr_to_bsr_on_device on arxiv
CONVERT_SHORT = 1000  # nnzb_max this far below the count: blocks dropped
DEFAULT_F64_CHUNK = 2048  # phase 8d: blocks a chunk of bsr_f64's float64 sums
# phase 8c, the bench harness, tuner and profiler
BENCH_OP = (2e-2, 128, 512)  # bench.py's op shape through the harness: p, b, F
BENCH_TIMER_TOL = 0.10       # the harness's ms vs cuda_ms on the same plan
BENCH_CHECK_BLOCK_ROWS = 8   # the op answer's block-rows held to spmm_scipy
BENCH_SCALE = 1.0            # the arxiv stand-in's scale in bench_graph & co
# spmm_tune's candidates: the JAX package's default ones and csr_pallas,
# at each block size; a bsr candidate whose f32 blocks exceed "auto"'s own
# memory guard (bsr_bytes_budget, 4 GiB) is not built (at b = 128 the
# arxiv stand-in holds 540,555 blocks: 35 GB on the host, then the card)
BENCH_TUNE = ("bsr_pallas", "bsr_xla", "csr_ell", "csr_xla", "hybrid", "windowed",
              "csr_pallas")
BENCH_TUNE_B = (128, 32)
BENCH_BLOCK_BUDGET = 4 << 30
BENCH_THIN_BUDGET = 1 << 30  # tune_with's case: "auto" over this budget
BENCH_ROOF_MAX = 1.05        # frac_of_roofline of the op record, at most
# the records of `python -m spmm_denseblock_tpu_torch.bench <sweep> --quick`:
# one density, block size, width and layout, both impls (bsrmm); one
# density and width, both impls (csrmm); both datasets, two orderings, one
# width, two impls (graph)
BENCH_QUICK_CASES = {"bsrmm": len(sweeps.BSR_GRID["impl"]),
                     "csrmm": len(sweeps.CSR_GRID["impl"]),
                     "graph": len(sweeps.GRAPH_GRID["datasets"]) * 2 * 2}
# the kernels the bench phase must launch: K2 (op shape), K1 (the quick
# bsrmm grid and the hybrid's dense part), K10 (csr_pallas)
BENCH_KERNELS = ("bsr_spmm_sorted", "bsr_spmm_flat", "csr_spmm")
_PALLAS = "spmm_denseblock_tpu/ops/bsr_spmm_pallas.py"
_PALLAS_I8 = "spmm_denseblock_tpu/ops/bsr_spmm_pallas_int8.py"
_CSRC = "spmm_denseblock_tpu_torch/csrc/"
_F = _CSRC + "bsr_spmm.cu"
_I8 = _CSRC + "bsr_spmm_int8.cu"
# (plan family, layout, products) -> (id, kernel, source, what it replaces:
# the pallas_call, or for K3 the _dot3 helper inside K1/K2/K5)
KERNEL_INFO = {
    ("csr",): ("K10", "csr_spmm", _CSRC + "csr_spmm.cu",
               "spmm_denseblock_tpu/ops/csr_spmm_pallas.py:112"),
    # K10 at one bf16 pass (precision="default": the same pallas_call at
    # jax.lax.Precision.DEFAULT)
    ("csr", "bf16"): ("K10", "csr_spmm_bf16", _CSRC + "csr_spmm.cu",
                      "spmm_denseblock_tpu/ops/csr_spmm_pallas.py:112"),
    # the f32 ELL tier (csr_ell): the JAX tier is XLA code, _ell_spmm_device
    ("ell",): ("K11", "ell_spmm", _CSRC + "csr_spmm.cu",
               "spmm_denseblock_tpu/ops/csr_spmm_ell.py:128"),
    ("f", "flat", "exact"): ("K1", "bsr_spmm_flat", _F, _PALLAS + ":909"),
    ("f", "flat", "bf16"): ("K1", "bsr_spmm_flat_bf16", _F, _PALLAS + ":909"),
    ("f", "sorted", "exact"): ("K2", "bsr_spmm_sorted", _F, _PALLAS + ":686"),
    ("f", "sorted", "bf16"): ("K2", "bsr_spmm_sorted_bf16", _F, _PALLAS + ":686"),
    ("f", "flat", "bf16x3"): ("K3", "bsr_spmm_flat_bf16x3", _F, _PALLAS + ":56"),
    ("f", "sorted", "bf16x3"): ("K3", "bsr_spmm_sorted_bf16x3", _F, _PALLAS + ":56"),
    ("f", "resident", "bf16x3"): ("K3", "bsr_spmm_resident_bf16x3", _F,
                                  _PALLAS + ":56"),
    # K3's operand split: the splits of _dot3 (its lines 76-79)
    ("split",): ("K3", "split_bf16", _F, _PALLAS + ":76"),
    ("f", "rowgroup", "exact"): ("K4", "bsr_spmm_rowgroup", _F, _PALLAS + ":412"),
    ("f", "rowgroup", "bf16"): ("K4", "bsr_spmm_rowgroup_bf16", _F, _PALLAS + ":412"),
    ("f", "resident", "exact"): ("K5", "bsr_spmm_resident", _F, _PALLAS + ":301"),
    ("f", "resident", "bf16"): ("K5", "bsr_spmm_resident_bf16", _F, _PALLAS + ":301"),
    ("i8", "flat"): ("K6", "bsr_spmm_int8_flat", _I8, _PALLAS_I8 + ":490"),
    ("i8", "sorted"): ("K7", "bsr_spmm_int8_sorted", _I8, _PALLAS_I8 + ":358"),
    ("i8", "rowgroup"): ("K8", "bsr_spmm_int8_rowgroup", _I8, _PALLAS_I8 + ":252"),
    ("i8", "resident"): ("K9", "bsr_spmm_int8_resident", _I8, _PALLAS_I8 + ":425"),
    # K6-K9's operand: the JAX plan's _quantize_cols (XLA code, its line
    # 512; _quantize_cols_static 520) and the zero pad, written in the
    # layout the kernel reads
    ("quantize",): ("K6-K9", "quantize_int8", _I8, _PALLAS_I8 + ":512"),
}
ALL_KERNELS = {f"K{i}" for i in range(1, 12)}
BSR_KERNELS = ALL_KERNELS - {"K10", "K11"}
# the card's published peaks, HBM_BYTES_S and PEAK_OPS_S, are
# utils/profiling's
ELEM_BYTES = {"f32": 4, "high": 4, "bf16": 2, "int8": 1}


def log(msg: str) -> None:
    print(msg, flush=True)


# each phase's seconds by the script's own clock, in order
PHASE_SECONDS: dict = {}


def phase_done(name: str, t0: float) -> float:
    """Records and logs the seconds since t0 as phase `name`; returns
    now, the next phase's start."""
    now = time.perf_counter()
    PHASE_SECONDS[name] = now - t0
    log(f"[phase] {name} in {now - t0:.1f} s")
    return now


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def launches() -> dict:
    return {k.symbol.replace("sdb_", ""): k.launches for k in _kernels.KERNELS}


def reset_launches() -> None:
    for k in _kernels.KERNELS:
        k.launches = 0


def kernel_of(plan) -> tuple:
    """(id, kernel, source, replaces) of the kernel a forward plan
    launches."""
    if plan.apply_fn is _ell_apply:
        return KERNEL_INFO[("ell",)]
    if plan.apply_fn is _csr_pallas_apply:  # a "default" plan holds bf16 values
        return KERNEL_INFO[("csr",) if plan.arrays[2].dtype == torch.float32
                           else ("csr", "bf16")]
    if plan.apply_fn is _int8_pallas_apply:
        return KERNEL_INFO[("i8", plan.statics[0])]
    layout, math = plan.statics[0], plan.statics[5]
    if math == "exact" and plan.arrays[2].dtype == torch.bfloat16:
        return KERNEL_INFO[("f", layout, "bf16")]  # their own bf16 entries
    return KERNEL_INFO[("f", layout, math)]


def rel_err(got, want) -> float:
    return (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)


def check_kernel(plan, x, label: str) -> float:
    """Kernel path vs plain path of one plan on the same device operand;
    returns max |kernel - plain|. Raises past KERNEL_TOL."""
    kid, name = kernel_of(plan)[:2]
    before = launches()[name]
    got = plan(x)
    torch.cuda.synchronize()
    if launches()[name] != before + 1:
        raise AssertionError(f"{label}: {name} did not launch")
    want = plain_apply(plan, x)
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{label}: bad output {tuple(got.shape)}")
    err = (got - want).abs().max().item()
    rel = rel_err(got, want)
    log(f"  {label:<52} {kid} {name:<26} max_abs_err={err:.3e} rel={rel:.3e}")
    if rel >= KERNEL_TOL:
        raise AssertionError(f"{label}: rel err {rel:.3e} >= {KERNEL_TOL}")
    return err


def seeded(shape, seed) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def ddi_graph(cache_dir: Path) -> CSR:
    """The ogbl-ddi stand-in at its published size under rcmk."""
    csr = load_dataset("ogbl-ddi", cache_dir=str(cache_dir), seed=SEED)
    return reorder(csr, "rcmk")[0]


def f32_rowgroup_plan(bsr: BSR) -> Plan:
    """K4 with f32 operands. The plan routes only bf16 to the row-group
    layout, so this packs it as the bf16 plan does (R=16, the pow2 group
    capped at 16) and keeps the blocks in f32."""
    cov = _ensure_covering(bsr)
    rows = cov.block_rows[: cov.nnzb]
    gh = min(_auto_group_pow2(cov.nnzb, np.unique(rows).size), 16)
    R, _ = _rowgroup_policy(2, gh)
    step_groups, slot_cols, blocks, n_groups = _pack_rowgroups(
        rows, cov.block_cols[: cov.nnzb], cov.blocks[: cov.nnzb], gh, R)
    group_ptr = group_pointer(step_groups, n_groups)
    order, depth = lane_order(group_ptr, R, gh)
    statics = ("rowgroup", cov.n_block_rows, *bsr.shape,
               cov.n_block_cols * bsr.b, "exact", depth, (R, gh))
    return Plan([step_groups, slot_cols, blocks, group_ptr, order],
                _pallas_apply, statics, device=DEV)


def variant_plans(bsr: BSR):
    """(label, plan) for every kernel and operand type of the port."""
    bf = torch.bfloat16
    f_plan = lambda **kw: bsr_spmm_pallas_plan(bsr, grad=False, device=DEV, **kw)
    i8_plan = lambda **kw: bsr_spmm_pallas_int8_plan(bsr, device=DEV, **kw)
    return [
        ("f32 depth_sort", f_plan(depth_sort=True)),
        ("f32 depth_sort=False", f_plan(depth_sort=False)),
        ("f32 row groups", f32_rowgroup_plan(bsr)),
        ("f32 precision=high depth_sort", f_plan(precision="high", depth_sort=True)),
        ("f32 precision=high depth_sort=False", f_plan(precision="high",
                                                       depth_sort=False)),
        ("f32 resident=True depth_sort=False", f_plan(resident=True,
                                                      depth_sort=False)),
        ("f32 resident=True precision=high", f_plan(
            resident=True, precision="high", depth_sort=False)),
        ("bf16 depth_sort", f_plan(dtype=bf, depth_sort=True)),
        ("bf16 depth_sort=False", f_plan(dtype=bf, depth_sort=False)),
        ("bf16 resident=False", f_plan(dtype=bf, resident=False)),
        ("bf16 resident=True precision=high", f_plan(dtype=bf, resident=True,
                                                     precision="high")),
        ("int8 depth_sort", i8_plan(depth_sort=True)),
        ("int8 per-slot scales", i8_plan(depth_sort=True, group_scale=False)),
        ("int8 depth_sort=False", i8_plan(depth_sort=False)),
        ("int8 resident=False", i8_plan(resident=False)),
        ("int8 resident=True f_tile=128", i8_plan(resident=True, f_tile=128)),
    ]


def csr_cases(adj):
    """(tag, csr, F) of K10's kernel checks: a ragged CSR whose rows 0-9
    (empty head rows) and 256-511 (an empty band) hold nothing, a
    rectangular asymmetric one, and ddi."""
    src = random_csr(0.03, 700, 500, seed=21)
    rows = src.row_ids()
    keep = ~np.isin(rows, list(range(10)) + list(range(256, 512)))
    ragged = CSR.from_coo(rows[keep], src.indices[keep], src.data[keep], (700, 500))
    return (
        ("csr 700x500 empty head rows and band F=7", ragged, 7),
        ("csr 3000x1200 F=64", random_csr(0.01, 3000, 1200, seed=22), 64),
        ("csr ddi F=256", adj, 256),
    )


def kernel_phase(adj) -> None:
    log("[kernels] every kernel against its plain version "
        f"(tolerance rel {KERNEL_TOL})")
    small = random_bsr(0.35, 37, 29, block_size=64, seed=3)
    small = BSR.from_parts(small.block_rows, small.block_cols, small.blocks,
                           (37 * 64 - 9, 29 * 64 - 5), 64)
    phantom = random_bsr(0.3, 7, 7, block_size=32, seed=9)
    # the pipelined FFMA loop at b = 128 on phantom lanes (K4 at R = 16)
    # and a ragged F (the operand padded to 136 columns)
    phantom128 = random_bsr(0.3, 7, 7, block_size=128, seed=10)
    shapes = (
        ("small b=64 F=200", small, 200, 4),
        ("7 block-rows b=32 F=96", phantom, 96, 6),
        ("7 block-rows b=128 F=133", phantom128, 133, 7),
        ("ddi b=128 F=256", csr_to_bsr(adj, 128), 256, 5),
    )
    for tag, bsr, F, seed in shapes:
        x = torch.as_tensor(seeded((bsr.shape[1], F), seed), device=DEV)
        checked = set()
        for label, p in variant_plans(bsr):
            check_kernel(p, x, f"{tag} {label}")
            checked.add(kernel_of(p)[0])
        if checked != BSR_KERNELS:
            raise AssertionError(f"{tag}: kernels checked {sorted(checked)}")
    for seed, (tag, csr, F) in enumerate(csr_cases(adj)):
        x = torch.as_tensor(seeded((csr.n_cols, F), 30 + seed), device=DEV)
        plan = csr_spmm_pallas_plan(csr, grad=False, device=DEV)
        check_kernel(plan, x, f"{tag} csr_pallas")
    k3_exactness()
    bf16_exactness()
    int8_exactness()


def k3_exactness() -> None:
    """Each K3 instance, and the exact kernel on its layout, on an input
    whose partial sums are all exact in f32: the order of a kernel's
    sums cannot matter, so K3 must give the bf16x3 answer and the exact
    kernel A X, bit for bit; at b = 16 and 32 (K3 on the small-block
    tensor-core loop, the exact kernels on the pipelined loop's small
    instances) and at b = 64 and 128 (K3 on the tensor-core ring, f32 K1,
    K2 and K5 on the pipelined FFMA loop). f32 K4 (a hand-packed plan: K3 has no row-group
    instance) must give A X too. Each K3 call splits its operand once."""
    for b in (16, 32, 64, 128):
        bsr, x, want3, want_exact = bf16x3_exact_case(F=200, seed=b, b=b)
        x = torch.as_tensor(x, device=DEV)
        n_diff = int((want3 != want_exact).sum())
        log(f"[kernels] b={b}: bf16x3 against exact f32 where every sum is exact "
            f"in f32: the answers differ (by A_lo X_lo) in {n_diff} of "
            f"{want3.size} entries, by up to {np.abs(want3 - want_exact).max():.0f}")
        for kw in ({}, {"depth_sort": False}, {"resident": True, "depth_sort": False}):
            for precision, want, what in (
                    ("high", want3, "A_hi X_hi + A_hi X_lo + A_lo X_hi"),
                    (None, want_exact, "A X")):
                plan = bsr_spmm_pallas_plan(bsr, grad=False, precision=precision,
                                            device=DEV, **kw)
                kid, name = kernel_of(plan)[:2]
                before = launches()
                got = plan(x)
                torch.cuda.synchronize()
                after = launches()
                splits = after["split_bf16"] - before["split_bf16"]
                if after[name] != before[name] + 1 or splits != (precision == "high"):
                    raise AssertionError(f"{name} did not launch once, or split "
                                         f"{splits} times")
                n_bad = int((got.double().cpu().numpy() != want).sum())
                log(f"  b={b:<3} {kid} {name:<26} == {what}: {n_bad} entries differ")
                if n_bad:
                    raise AssertionError(f"b={b} {name}: {n_bad} entries differ "
                                         f"from {what}")
        exact_launch(f32_rowgroup_plan(bsr), x,
                     torch.as_tensor(want_exact, device=DEV).float(),
                     f"b={b} f32 row groups == A X")


def exact_launch(plan, x, want, label: str) -> None:
    """One launch of a plan's kernel, its answer equal to `want` bit for
    bit."""
    kid, name = kernel_of(plan)[:2]
    before = launches()[name]
    got = plan(x)
    torch.cuda.synchronize()
    if launches()[name] != before + 1:
        raise AssertionError(f"{label}: {name} did not launch")
    n_bad = int((got != want).sum())
    log(f"  {label:<52} {kid} {name:<26} {n_bad} entries differ")
    if n_bad or got.shape != want.shape:
        raise AssertionError(f"{label}: {name}: {n_bad} entries differ")


# the bf16 plan's arguments that pack each layout (K2, K4, K1, K5)
BF16_LAYOUT_KW = {"sorted": {"depth_sort": True}, "rowgroup": {"depth_sort": False},
                  "flat": {"resident": False},
                  "resident": {"precision": "high", "resident": True}}


def bf16_layout_plan(bsr, layout: str) -> Plan:
    plan = bsr_spmm_pallas_plan(bsr, dtype=torch.bfloat16, grad=False, device=DEV,
                                **BF16_LAYOUT_KW[layout])
    if plan.statics[0] != layout:
        raise AssertionError(f"bf16 plan took {plan.statics[0]}, expected {layout}")
    return plan


def bf16_exactness() -> None:
    """The bf16 K1, K2, K4 and K5 entries on bf16_exact_case, whose
    partial sums are integers under 2^24: exact in f32 in any order, so
    each kernel must equal float64 bit for bit (the tensor-core ring at
    b = 64 and 128, the small-block mma.sync loop below; F=70 pads the
    operand to 72 columns)."""
    log("[kernels] bf16 K1, K2, K4 and K5 where every sum is exact in f32 "
        "(bf16_exact_case): each must equal float64 bit for bit")
    for b in (16, 32, 64, 128):
        for F in (70, 256):
            bsr, x, want = bf16_exact_case(b, F, seed=b + F)
            x = torch.as_tensor(x, device=DEV)
            want = torch.as_tensor(want, device=DEV).float()
            for layout in BF16_LAYOUT_KW:
                exact_launch(bf16_layout_plan(bsr, layout), x, want,
                             f"b={b} F={F} bf16 {layout}")


# the int8 plan's arguments that pack K7's (both scale modes), K8's, K6's
# and K9's layouts
INT8_RING_KW = {"sorted": {"depth_sort": True},
                "sorted per-slot": {"depth_sort": True, "group_scale": False},
                "rowgroup": {"depth_sort": False},
                "flat": {"resident": False},
                "resident": {"resident": True, "f_tile": 128}}


def int8_exactness() -> None:
    """K7 (both scale modes), K8, K6 and K9 on the small-block int8
    tensor-core loop (b = 16 and 32) and on the int8 tensor-core ring (b =
    64 and 128) on int8_exact_case, where every partial sum is exact in
    f32 and the one rounding is the column scale's: each must equal
    float64 bit for bit. 37 block-rows leave absent (K7) and phantom (K8)
    lanes and an empty row (K6, K9); F=70 is ragged."""
    log("[kernels] int8 K6-K9 on the small-block loop and on the ring where "
        "nothing rounds before the column scale (int8_exact_case): each must "
        "equal float64 bit for bit")
    for b in (16, 32, 64, 128):
        for F in (70, 256):
            bsr, x, want = int8_exact_case(b, F, seed=b + F, n_block_rows=37)
            x = torch.as_tensor(x, device=DEV)
            want = torch.as_tensor(want, device=DEV).float()
            for label, kw in INT8_RING_KW.items():
                plan = bsr_spmm_pallas_int8_plan(bsr, device=DEV, **kw)
                exact_launch(plan, x, want,
                             f"b={b} F={F} int8 {label} BN={int8_bn(plan, F)}")


def int8_bn(plan, F: int) -> int:
    """The F tile width an int8 plan's kernel launches at on this card
    (the small-block loop's at b = 16 and 32 with the plan's deepest
    lane, the ring's at 64 and 128)."""
    qblocks = plan.arrays[2]
    return int8_tile_bn(qblocks.shape[1], plan.statics[1], F, _sm_count(0),
                        qblocks.shape[0], plan.statics[6])


def gcn_reference(adj, params, x) -> np.ndarray:
    h = x.astype(np.float64)
    a64 = adj.to_scipy().astype(np.float64)
    for i, p in enumerate(params):
        h = a64 @ h @ p["w"] + p["b"]
        if i < len(params) - 1:
            h = np.maximum(h, 0.0)
    return h


def slice_phase(adj, dims, n_requests: int):
    """f32 GCN serving on the ddi stand-in; returns (plan, model, xs,
    refs)."""
    log(f"[slice] GCN {dims} on ogbl-ddi stand-in: n={adj.n_rows} "
        f"nnz={adj.nnz}, {n_requests} requests, f32")
    plan = spmm_plan(adj, impl="bsr_pallas", block_size=128, grad=False,
                     device=DEV)
    if kernel_of(plan)[0] != "K2":
        raise AssertionError(f"ddi plan took {plan.statics[0]}, expected sorted (K2)")
    gen = torch.Generator().manual_seed(SEED)
    model = GCN(dims, generator=gen).to(DEV)
    params = [{k: v.detach().cpu().double().numpy() for k, v in p.items()}
              for p in model.params()]
    xs, refs = [], []
    for r in range(n_requests):
        x = seeded((adj.n_rows, dims[0]), SEED + 100 + r)
        with torch.no_grad():
            out = model(plan, torch.as_tensor(x, device=DEV))
        torch.cuda.synchronize()
        h = gcn_reference(adj, params, x)
        if out.shape != h.shape or not torch.isfinite(out).all():
            raise AssertionError(f"request {r}: bad output {tuple(out.shape)}")
        assert_allclose(out, h, eps=CHECK_EPS, msg=f"request {r}")
        err = np.abs(out.cpu().double().numpy() - h).max()
        log(f"  request {r}: out {tuple(out.shape)} finite, max_abs_err vs "
            f"f64 reference {err:.3e} (< {CHECK_EPS} gate)")
        xs.append(torch.as_tensor(x, device=DEV))
        refs.append(h)
    return plan, model, xs, refs


def csr_slice_phase(adj, model, xs, refs):
    """f32 GCN serving on the ddi stand-in through the CSR plan (K10), the
    same requests as the BSR slice; returns the plan."""
    log(f"[slice] the same {len(xs)} requests through the CSR tier "
        "(spmm_plan(adj, impl='csr_pallas'))")
    plan = spmm_plan(adj, impl="csr_pallas", grad=False, device=DEV)
    if kernel_of(plan)[0] != "K10":
        raise AssertionError(f"ddi csr_pallas plan runs {kernel_of(plan)}")
    deg = np.diff(adj.indptr)
    log(f"  {adj.n_rows} rows of {deg.mean():.1f} nonzeros on average, at most "
        f"{deg.max()} (duplicate edges kept); {plan.arrays[8].numel()} rows "
        f"split into segments of <= {SEGMENT_NNZ}, {plan.arrays[5].numel()} "
        "segments")
    for r, (x, h) in enumerate(zip(xs, refs)):
        with torch.no_grad():
            out = model(plan, x)
        torch.cuda.synchronize()
        if out.shape != h.shape or not torch.isfinite(out).all():
            raise AssertionError(f"csr request {r}: bad output {tuple(out.shape)}")
        assert_allclose(out, h, eps=CHECK_EPS, msg=f"csr request {r}")
        err = np.abs(out.cpu().double().numpy() - h).max()
        log(f"  csr request {r}: out {tuple(out.shape)} finite, max_abs_err vs "
            f"f64 reference {err:.3e} (< {CHECK_EPS} gate)")
    return plan


def int8_slice_phase(adj, model, xs, refs):
    """int8 GCN serving on the ddi stand-in through spmm_plan(dtype=int8);
    returns the plan and the largest SpMM max |kernel - plain|."""
    log(f"[slice] the same {len(xs)} requests, int8 "
        "(spmm_plan(impl='bsr_pallas', dtype=torch.int8))")
    plan = spmm_plan(adj, impl="bsr_pallas", block_size=128, grad=False,
                     dtype=torch.int8, device=DEV)
    if kernel_of(plan)[0] != "K7" or not plan.statics[5][3]:
        raise AssertionError(f"ddi int8 plan took {plan.statics}, expected "
                             "sorted group-scale (K7)")
    bn = int8_tile_bn(128, plan.statics[1], model.dims[0], _sm_count(0))
    log(f"  int8 K7 on the tensor-core ring at BN={bn} ({plan.statics[1]} "
        f"block-rows, F={model.dims[0]})")
    spmm_errs = []
    spmm = checked_spmm(plan, spmm_errs)
    serve_requests("int8", lambda x: model(spmm, x), xs, refs, "int8", spmm_errs)
    return plan, max(spmm_errs)


def bf16_slice_phase(adj, model, xs, refs):
    """bf16 GCN serving on the ddi stand-in through spmm_plan(dtype=
    bfloat16) (bf16 K2 on the tensor cores); returns the plan and the
    largest SpMM max |kernel - plain|."""
    log(f"[slice] the same {len(xs)} requests, bf16 "
        "(spmm_plan(impl='bsr_pallas', dtype=torch.bfloat16))")
    plan = spmm_plan(adj, impl="bsr_pallas", block_size=128, grad=False,
                     dtype=torch.bfloat16, device=DEV)
    if kernel_of(plan)[1] != "bsr_spmm_sorted_bf16":
        raise AssertionError(f"ddi bf16 plan runs {kernel_of(plan)[:2]}, "
                             "expected bf16 K2")
    bn = bf16_tile_geometry(128, plan.statics[1], model.dims[0], _sm_count(0))[0]
    log(f"  bf16 K2 at BN={bn} ({plan.statics[1]} block-rows, F={model.dims[0]})")
    spmm_errs = []
    spmm = checked_spmm(plan, spmm_errs)
    serve_requests("bf16", lambda x: model(spmm, x), xs, refs, "bf16", spmm_errs)
    return plan, max(spmm_errs)


def train_phase(adj, dims, precision, impl: str = "bsr_pallas",
                n_steps: int = 5):
    """Trains the GCN on the ddi stand-in through spmm_plan's default
    grad plan for n_steps Adam steps; checks step 0's gradients against
    a float64 host autograd reference on the dense A, the launches of
    every step, and that the loss falls. Returns what the timing needs."""
    tag = "f32" if precision is None else f"precision={precision!r}"
    kw = {} if precision is None else {"precision": precision}
    plan = spmm_plan(adj, impl=impl, block_size=128, device=DEV, **kw)
    fwd, bwd = plan.arrays
    kids = (kernel_of(fwd), kernel_of(bwd))
    if impl == "csr_pallas":
        tag, want_kid = "csr", "K10"
        layouts_ok = True
    else:
        want_kid = "K2" if precision is None else "K3"
        layouts_ok = {fwd.statics[0], bwd.statics[0]} == {"sorted"}
    if [k[0] for k in kids] != [want_kid] * 2 or not layouts_ok:
        raise AssertionError(f"train {tag}: plans run {kids[0][:2]} "
                             f"{kids[1][:2]}, expected {want_kid}")
    name = kids[0][1]
    log(f"[train] GCN {dims} on ogbl-ddi stand-in, {tag}: spmm_plan's {impl} "
        f"grad plan ({want_kid} {name} on A and on Aᵀ), {n_steps} Adam(lr=1e-2) "
        "steps")
    n = adj.n_rows
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    y = rng.integers(0, dims[-1], size=n).astype(np.int64)
    mask = (rng.random(n) < 0.6).astype(np.float32)
    params = init_gcn(dims, generator=torch.Generator().manual_seed(SEED),
                      device=DEV)
    batch = tuple(torch.as_tensor(a, device=DEV) for a in (x, y, mask))
    with torch.no_grad():  # step 0's forward: the kernels are deterministic
        zs = preactivations(params, plan, batch[0])
    ref = train_reference(adj, params, x, y, mask, zs)
    step, init_state = make_train_step(
        gcn_apply, plan, functools.partial(torch.optim.Adam, lr=1e-2))
    state = init_state(params)
    losses = []
    for i in range(n_steps):
        before = launches()[name]
        params, state, metrics = step(params, state, *batch)
        torch.cuda.synchronize()
        if launches()[name] - before != 3:
            raise AssertionError(f"train {tag} step {i}: {name} launched "
                                 f"{launches()[name] - before} times, expected 3")
        losses.append(metrics["loss"].item())
        if i == 0:
            check_step0(tag, params, ref, losses[0], FLIP_CAP[precision])
    final = make_eval_step(gcn_apply, plan)(params, *batch)["loss"].item()
    log(f"  losses {' '.join(f'{v:.5f}' for v in losses)}; after "
        f"{n_steps} steps {final:.5f}")
    if not np.isfinite(losses + [final]).all() or not final < losses[0]:
        raise AssertionError(f"train {tag}: loss did not fall ({losses}, {final})")
    return plan, step, state, params, batch


def preactivations(params, spmm, x):
    """The hidden layers' pre-activations z of gcn_apply(params, spmm,
    x)."""
    zs, h = [], x
    for p in params[:-1]:
        zs.append(linear(p, spmm(h)))
        h = torch.relu(zs[-1])
    return zs


def train_reference(adj, params, x, y, mask, zs):
    """Float64 host autograd through the dense A, given the kernel run's
    hidden pre-activations zs. Returns the loss and the parameter
    gradients with the ReLUs at the kernel run's activation pattern
    (zs > 0), the gradients of the plain float64 model, and how the
    pre-activations compare with float64's z64: the count of signs that
    differ, the largest |z64| among them and the largest |z - z64|, both
    relative to max |z64|. The gradient jumps where a pre-activation
    changes sign, so a rounding difference next to 0 moves it by far
    more than the rounding itself; the gate compares on one activation
    pattern, and bounds the flips apart."""
    a64 = torch.as_tensor(adj.to_dense(), dtype=torch.float64)
    x64 = torch.as_tensor(x).double()
    y_t, m64 = torch.as_tensor(y), torch.as_tensor(mask).double()
    zs = [z.cpu().double() for z in zs]
    out, z64s = [], []
    for fixed in (True, False):
        p64 = [{k: v.detach().cpu().double().requires_grad_(True)
                for k, v in p.items()} for p in params]
        h = x64
        for i, p in enumerate(p64):
            h = linear(p, a64 @ h)
            if i < len(p64) - 1:
                if not fixed:
                    z64s.append(h.detach())
                h = h * (zs[i] > 0) if fixed else torch.relu(h)
        loss = masked_cross_entropy(h, y_t, m64)
        loss.backward()
        out.append((loss.item(), [{k: v.grad for k, v in p.items()} for p in p64]))
    flips, flipped, dev = 0, 0.0, 0.0
    for z, z64 in zip(zs, z64s):
        scale = z64.abs().max()
        f = (z > 0) != (z64 > 0)
        flips += int(f.sum())
        if f.any():
            flipped = max(flipped, (z64[f].abs().max() / scale).item())
        dev = max(dev, ((z - z64).abs().max() / scale).item())
    (loss, grads), (_, plain_grads) = out
    return loss, grads, plain_grads, (flips, flipped, dev)


def grad_err(params, grads) -> float:
    """Largest max |err| / max |ref| over the parameters' gradients."""
    return max(
        ((p[k].grad.detach().cpu().double() - g[k]).abs().max()
         / g[k].abs().max()).item()
        for p, g in zip(params, grads) for k in ("w", "b"))


def check_step0(tag, params, ref, loss, flip_cap: int):
    ref_loss, grads, plain_grads, (flips, flipped, dev) = ref
    err = grad_err(params, grads)
    log(f"  step 0: loss {loss:.6f} (float64 {ref_loss:.6f}); every parameter "
        f"gradient within {err:.3e} of float64 on the kernel run's ReLU "
        f"pattern (< {GRAD_TOL}, max |err| / max |ref|); against the float64 "
        f"model's own pattern within {grad_err(params, plain_grads):.3e}")
    log(f"  step 0: hidden pre-activations within {dev:.3e} of float64 "
        f"(/ max |z64|); {flips} change sign (<= {flip_cap}), the largest "
        f"|z64| among them {flipped:.3e} (<= 2^-16 = {FLIP_REL:.3e})")
    if not err < GRAD_TOL:
        raise AssertionError(f"train {tag}: step-0 gradient rel err {err:.3e} "
                             f">= {GRAD_TOL}")
    if flips > flip_cap or flipped > FLIP_REL:
        raise AssertionError(f"train {tag}: {flips} pre-activations change "
                             f"sign, up to {flipped:.3e} of max |z64| from 0")


def op_plans(bsr, calibration):
    """bench.py's op shape: f32, bf16x3 ("high") and bf16 and int8, each
    layout. Keys (tag, layout)."""
    bf = torch.bfloat16
    f_plan = lambda **kw: bsr_spmm_pallas_plan(bsr, grad=False, device=DEV, **kw)
    i8_plan = lambda **kw: bsr_spmm_pallas_int8_plan(
        bsr, calibration=calibration, device=DEV, **kw)
    specs = (
        ("f32", "sorted", lambda: f_plan()),
        ("f32", "flat", lambda: f_plan(depth_sort=False)),
        ("f32", "resident", lambda: f_plan(resident=True, depth_sort=False)),
        ("f32", "rowgroup", lambda: f32_rowgroup_plan(bsr)),
        ("high", "sorted", lambda: f_plan(precision="high")),
        ("high", "flat", lambda: f_plan(precision="high", depth_sort=False)),
        ("high", "resident", lambda: f_plan(precision="high", resident=True,
                                            depth_sort=False)),
        ("bf16", "sorted", lambda: f_plan(dtype=bf)),
        ("bf16", "rowgroup", lambda: f_plan(dtype=bf, depth_sort=False)),
        ("bf16", "flat", lambda: f_plan(dtype=bf, resident=False)),
        ("bf16", "resident", lambda: f_plan(dtype=bf, precision="high",
                                            resident=True)),
        ("int8", "sorted", lambda: i8_plan()),
        ("int8", "rowgroup", lambda: i8_plan(depth_sort=False)),
        ("int8", "flat", lambda: i8_plan(resident=False)),
        ("int8", "resident", lambda: i8_plan(resident=True, f_tile=128)),
    )
    plans = {}
    for tag, layout, build in specs:
        p = build()
        if p.statics[0] != layout:
            raise AssertionError(f"op {tag} took {p.statics[0]}, expected {layout}")
        plans[(tag, layout)] = p
    return plans


def op_phase(op_bsr, x_op, calibration):
    """Phase 6: every op plan against its plain version, the int8 answers
    against f32 K2, bench.py's bf16x3 self-check. Returns (plans,
    errs)."""
    t0 = time.perf_counter()
    plans = op_plans(op_bsr, calibration)
    log(f"[op] random_bsr(2e-2, 1024, b=128): nnzb={op_bsr.nnzb}, "
        f"F={x_op.shape[1]}, {len(plans)} plans built in "
        f"{time.perf_counter() - t0:.1f} s")
    errs, outs = {}, {}
    for (tag, layout), p in plans.items():
        errs[(tag, layout)] = check_kernel(p, x_op, f"op {tag} {layout}")
        if tag != "bf16":
            outs[(tag, layout)] = p(x_op)
    ref = outs[("f32", "sorted")]
    for (tag, layout), out in outs.items():
        if tag == "int8":
            rel = rel_to(out, ref)
            log(f"  op int8 {layout:<8} vs f32 K2: rel err {rel:.3e} (< {INT8_TOL})")
            if rel >= INT8_TOL:
                raise AssertionError(f"op int8 {layout}: rel err {rel:.3e}")
    op_bf16_exactness(op_bsr)
    # bench.py's bf16x3 self-check, against exact f32 K2 and the bsr_xla tier
    xla_out = bsr_spmm_xla_plan(op_bsr, device=DEV)(x_op)
    log(f"  bsr_xla vs f32 K2: rel err {rel_to(xla_out, ref):.3e}")
    for layout in ("sorted", "flat", "resident"):
        high = outs[("high", layout)]
        for what, want in (("exact f32 K2", ref), ("bsr_xla", xla_out)):
            rel = rel_to(high, want)
            log(f"  bf16x3 self-check: high {layout:<8} vs {what:<12} max |err| "
                f"/ max |ref| {rel:.3e} (< {BF16X3_TOL})")
            if not rel < BF16X3_TOL:
                raise AssertionError(f"bf16x3 {layout} vs {what}: {rel:.3e}")
    return plans, errs


def check_split(x) -> float:
    """K3's operand split (split_operand) on the op operand against its
    plain version: bit for bit. Returns max |kernel - plain| (0)."""
    before = launches()["split_bf16"]
    got = split_operand(x)
    torch.cuda.synchronize()
    if launches()["split_bf16"] != before + 1:
        raise AssertionError("split_bf16 did not launch")
    want = split_operand_plain(x)
    n_bad = int((got != want).sum()) if got.shape == want.shape else -1
    log(f"  op K3 operand split {tuple(x.shape)} -> {tuple(got.shape)} bf16 planes: "
        f"{n_bad} entries differ from its plain version")
    if n_bad:
        raise AssertionError(f"split_bf16: {n_bad} entries differ")
    return (got.float() - want.float()).abs().max().item()


def check_quantize(x, n_out: int, cs_static, where: str) -> float:
    """The int8 operand's quantization (quantize_int8) on x against its
    plain version (quantize_per_column with the pad, then
    transpose_operand), bit for bit: dynamic scales, and static ones when
    cs_static is given, (N, F) and transposed. Returns max |kernel -
    plain| of the values (0)."""
    err = 0.0
    for cs in (None, cs_static) if cs_static is not None else (None,):
        static = cs is not None
        for transposed in (False, True):
            before = launches()["quantize_int8"]
            q, got_cs = quantize_int8(x, n_out, cs, transposed)
            torch.cuda.synchronize()
            if launches()["quantize_int8"] != before + 1:
                raise AssertionError("quantize_int8 did not launch")
            want, want_cs = quantize_int8_plain(x, n_out, cs, transposed)
            n_bad = (int((q != want).sum()) + int((got_cs != want_cs).sum())
                     if q.shape == want.shape else -1)
            log(f"  {where} int8 operand quantization {tuple(x.shape)} -> "
                f"{tuple(q.shape)}, {'static' if static else 'dynamic'} scales: "
                f"{n_bad} values or scales differ from its plain version")
            if n_bad:
                raise AssertionError(f"quantize_int8: {n_bad} entries differ")
            err = max(err, (q.float() - want.float()).abs().max().item())
    return err


def op_bf16_exactness(op_bsr) -> None:
    """The bf16 K1, K2, K4 and K5 entries at the op shape (the
    tensor-core loop at its widest tile) on the op matrix's blocks with
    integer values of
    magnitude <= 16 and an integer operand: every partial sum is an
    integer under 2^24, exact in f32 in any order, so each kernel must
    equal its plain version bit for bit."""
    rng = np.random.default_rng(SEED + 7)
    n = op_bsr.nnzb
    ints = rng.integers(-16, 17, size=(n, op_bsr.b, op_bsr.b), dtype=np.int8)
    bsr = BSR.from_parts(op_bsr.block_rows[:n], op_bsr.block_cols[:n],
                         ints.astype(np.float32), op_bsr.shape, op_bsr.b)
    deepest = np.bincount(op_bsr.block_rows[:n]).max()
    if deepest * op_bsr.b * 16 * 16 >= 2 ** 24:
        raise AssertionError(f"{deepest} blocks in a row: sums may round")
    x = torch.as_tensor(rng.integers(-16, 17, size=(op_bsr.shape[1], 512),
                                     dtype=np.int8), device=DEV).float()
    bn = bf16_tile_geometry(op_bsr.b, op_bsr.n_block_rows, 512, _sm_count(0))[0]
    for layout in BF16_LAYOUT_KW:
        plan = bf16_layout_plan(bsr, layout)
        exact_launch(plan, x, plain_apply(plan, x),
                     f"op bf16 {layout} integer values, BN={bn}")


# the exact-f32 entries, which run the pipelined FFMA loop at b = 64 and 128
F32_PIPE_KERNELS = ("bsr_spmm_sorted", "bsr_spmm_flat", "bsr_spmm_resident",
                    "bsr_spmm_rowgroup")


def tile_bn(name: str, bsr: BSR, F: int):
    """The F tile width a kernel of the op plans (b >= 64) launched at, or
    None below (bsr_row gives the reorder plans' widths) and for tiles
    that are not BSR tiles: the tensor-core loops (bf16 entries and K3,
    int8 K6-K9, at b >= 64) and the exact-f32 kernels' pipelined loop
    (K1, K2, K4, K5) pick theirs from the grid."""
    if bsr.b < 64:
        return None
    if name.endswith(("_bf16", "_bf16x3")):
        return bf16_tile_geometry(bsr.b, bsr.n_block_rows, F, _sm_count(0))[0]
    if name in F32_PIPE_KERNELS:
        return tile_geometry(bsr.b, bsr.n_block_rows, F, _sm_count(0), 4)[0]
    if name.startswith("bsr_spmm_int8_"):
        return int8_tile_bn(bsr.b, bsr.n_block_rows, F, _sm_count(0))
    return None


def rel_to(got, want) -> float:
    return (got - want).abs().max().item() / want.abs().max().item()


def csr_op_phase(op_csr, x_op):
    """K10 at the reference's test_csrmm shape against its plain version
    and within 1e-4 of the csr_xla tier's answer. Returns (plan, max
    |kernel - plain|)."""
    t0 = time.perf_counter()
    plan = csr_spmm_pallas_plan(op_csr, grad=False, device=DEV)
    log(f"[op] random_csr(2e-3, 2^17, seed={SEED}): nnz={op_csr.nnz}, "
        f"F={x_op.shape[1]}, {plan.arrays[0].numel()} padded slots, plan built "
        f"in {time.perf_counter() - t0:.1f} s")
    err = check_kernel(plan, x_op, "op csr K10")
    got = plan(x_op)
    xla_out = csr_spmm_plan(op_csr, device=DEV)(x_op)
    rel = rel_to(got, xla_out)
    log(f"  op K10 vs csr_xla: max |err| / max |ref| {rel:.3e} (< {CHECK_EPS})")
    if not rel < CHECK_EPS:
        raise AssertionError(f"op K10 vs csr_xla: {rel:.3e}")
    return plan, err


def reorder_phase(cache_dir: Path):
    """Phase 7: the reference's question on the card, as the JAX
    package's bench_graph asks it for the CSR and BSR tiers. The
    ogbn-arxiv stand-in at its published size under each of
    REORDER_ORDERINGS (the native engine; rcmk held bit for bit to its
    numpy body, every permutation checked), its block metrics and
    bandwidth; K10 (csr_pallas) on each ordering at F = 128 against its
    plain version and within 1e-4 of spmm_scipy; then, on the ordering
    with the fewest 32 x 32 blocks, REORDER_BSR's plans (bsr_pallas: f32
    K2 at b = 32 and 16, K1 at 32, on the pipelined FFMA loop's small
    instances; bf16 K2 and K3 sorted at 32 and 16, on the small-block
    tensor-core loop; int8 K7 at 32 and 16, on the small-block int8
    tensor-core loop), each against its plain version and spmm_scipy
    (int8 at INT8_TOL of max |ref|). Returns what the timing needs.

    X is the reference's check_result operand, seeded signs of 0.5: on a
    graph of ones every partial sum is then a multiple of 0.5 under 2^23,
    exact in f32 in any order, so the 1e-4 gate measures the kernels. On
    standard-normal X two correct f32 answers differ by more than 1e-4
    where a hub row (10,308 nonzeros) sums to near 0: spmm_scipy's own
    sequential f32 sum is no closer to the exact answer than that. On
    signs every product is exact in bf16 too, so reorder_normal_check
    holds the same plans on standard-normal X as well."""
    t0 = time.perf_counter()
    csr = load_dataset(REORDER_DATASET, cache_dir=str(cache_dir),
                       scale=REORDER_SCALE, seed=SEED)
    log(f"[setup] {REORDER_DATASET} ({dataset_provenance(REORDER_DATASET)}, scale "
        f"{REORDER_SCALE}) in {time.perf_counter() - t0:.1f} s: {graph_stats(csr)}")
    signs = np.random.default_rng(SEED + 11).integers(0, 2, (csr.n_cols, REORDER_F))
    x_np = (signs.astype(np.float32) - 0.5)
    x = torch.as_tensor(x_np, device=DEV)
    runs = {}
    for name in REORDER_ORDERINGS:
        t0 = time.perf_counter()
        old2new = STRATEGIES[name](csr)
        host_s = time.perf_counter() - t0
        check_permutation(old2new, csr.n_rows)
        if name == "rcmk":
            t0 = time.perf_counter()
            plain = rcm_variant(csr, impl="python")
            if not np.array_equal(old2new, plain):
                raise AssertionError("rcmk: the native permutation differs from numpy's")
            log(f"  reorder rcmk: native = numpy permutation, bit for bit (numpy "
                f"{time.perf_counter() - t0:.2f} s)")
        t0 = time.perf_counter()
        rcsr = permutate(old2new, csr)
        perm_s = time.perf_counter() - t0
        metrics = block_metrics(rcsr, REORDER_BLOCK_SIZES)
        bp = bandwidth_profile(rcsr)
        log(f"[reorder] {name}: ordering {host_s:.3f} s, permutate {perm_s:.3f} s "
            f"(host, native); bandwidth={int(bp['bandwidth'])} "
            f"profile={int(bp['profile'])} avg_span={bp['avg_span']:.1f}")
        for b, m in metrics.items():
            log(f"  {name} b={b:4d}: nnzb={int(m['nnzb']):9d} density={m['density']:.6f} "
                f"utilization={m['utilization']:.5f} avg={m['average']:.2f}")
        t0 = time.perf_counter()
        plan = spmm_plan(rcsr, impl="csr_pallas", grad=False, device=DEV)
        plan_s = time.perf_counter() - t0
        check_kernel(plan, x, f"reorder {name} csr K10 F={REORDER_F}")
        log(f"  reorder {name} K10 vs spmm_scipy: "
            f"{assert_allclose(plan(x), spmm_scipy(rcsr, x_np), msg=name):.3e} "
            f"(< {CHECK_EPS}); plan built in {plan_s:.2f} s")
        runs[name] = {"csr": rcsr, "plan": plan, "metrics": metrics,
                      "host_s": host_s}
    best = min(REORDER_ORDERINGS,
               key=lambda k: runs[k]["metrics"][REORDER_B]["nnzb"])
    want = spmm_scipy(runs[best]["csr"], x_np)
    bsrs, bsr_runs = {}, []
    for kid, b, kw, name in REORDER_BSR:
        t0 = time.perf_counter()
        if b not in bsrs:
            bsrs[b] = csr_to_bsr(runs[best]["csr"], b)
        bsr = bsrs[b]
        bplan = spmm_plan(bsr, impl="bsr_pallas", block_size=b, grad=False,
                          device=DEV, **kw)
        bplan_s = time.perf_counter() - t0
        if kernel_of(bplan)[1] != name:
            raise AssertionError(f"reorder b={b} {kw}: {kernel_of(bplan)[1]}, "
                                 f"expected {name}")
        label = f"reorder {best} bsr {kid} b={b} F={REORDER_F}"
        log(f"[reorder] BSR on {best} (the fewest {REORDER_B} x {REORDER_B} blocks), "
            f"{kid} b={b}: nnzb={bsr.nnzb}, {plan_slots(bplan)} slots, "
            f"deepest lane {bplan.statics[6]} slots, conversion and plan "
            f"{bplan_s:.1f} s (host)")
        before = launches()[name]
        err = check_kernel(bplan, x, label)
        if plan_tag(bplan) == "int8":  # the int8 tier's gate: max |err| / max |ref|
            rel = rel_err(bplan(x), torch.as_tensor(want, device=DEV))
            log(f"  {label} vs spmm_scipy: rel {rel:.3e} (< {INT8_TOL})")
            if not rel < INT8_TOL:
                raise AssertionError(f"{label}: rel err {rel:.3e} vs spmm_scipy")
        else:
            log(f"  {label} vs spmm_scipy: "
                f"{assert_allclose(bplan(x), want, msg=label):.3e} (< {CHECK_EPS})")
        bsr_runs.append({"kid": kid, "bsr": bsr, "plan": bplan, "plan_s": bplan_s,
                         "label": label, "err": err,
                         "launches": launches()[name] - before})
    return {"x": x, "runs": runs, "best": best, "bsr_runs": bsr_runs}


def plan_slots(plan) -> int:
    """A BSR plan's slots (zero pads included; a "high" plan holds its
    blocks as two bf16 planes of S*b rows)."""
    blocks = plan.arrays[2]
    return blocks.shape[0] // (2 * blocks.shape[1]) if blocks.dim() == 2 else blocks.shape[0]


def plan_tag(plan) -> str:
    """The products a BSR kernel plan runs, as bound() names them: "f32",
    "bf16", "high" (K3) or "int8"."""
    name = kernel_of(plan)[1]
    if name.startswith("bsr_spmm_int8"):
        return "int8"
    return "high" if name.endswith("_bf16x3") else "bf16" if name.endswith("_bf16") else "f32"


def reorder_normal_check(rp: dict) -> None:
    """The reorder phase's plans on a standard-normal X of the same shape,
    where an operand rounded below f32 (bf16, TF32) shows: each kernel
    against its plain version (KERNEL_TOL; the hub lanes' long sums
    included) and, but for the bf16 plans, against a float64 scipy
    product (CHECK_EPS, relative to its max |ref|; int8 at its tier's
    INT8_TOL). Run after the phase's counts are read: these launches do
    not count."""
    csr0 = next(iter(rp["runs"].values()))["csr"]
    x_np = seeded((csr0.n_cols, REORDER_F), SEED + 12)
    x = torch.as_tensor(x_np, device=DEV)
    x64 = x_np.astype(np.float64)

    def against_f64(plan, rcsr, label: str, eps: float = CHECK_EPS) -> None:
        got = plan(x).double().cpu().numpy()
        want = rcsr.to_scipy().astype(np.float64) @ x64
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1.0)
        log(f"  {label} vs float64 scipy: rel {err:.3e} (< {eps})")
        if not err < eps:
            raise AssertionError(f"{label}: rel err {err:.3e} vs float64 >= {eps}")

    for name, run in rp["runs"].items():
        label = f"reorder {name} csr K10 F={REORDER_F} normal X"
        check_kernel(run["plan"], x, label)
        against_f64(run["plan"], run["csr"], label)
    for br in rp["bsr_runs"]:
        label = br["label"] + " normal X"
        check_kernel(br["plan"], x, label)
        tag = plan_tag(br["plan"])
        if tag != "bf16":  # bf16 rounds the operand: plain only
            against_f64(br["plan"], rp["runs"][rp["best"]]["csr"], label,
                        INT8_TOL if tag == "int8" else CHECK_EPS)


def tier_of(plan) -> str:
    """The tier a served plan runs, as spmm_plan names it."""
    if plan.apply_fn is _sum_apply:  # named by its first part
        return {_pallas_apply: "hybrid", _int8_pallas_apply: "hybrid_int8",
                _windowed_apply: "windowed", _windowed_int8_apply: "windowed_int8",
                }[plan.subplans[0].apply_fn]
    if plan.apply_fn is _ell_apply:
        return "csr_ell"
    if plan.apply_fn is _ell_int8_apply:
        return "csr_ell_int8"
    if plan.apply_fn is _csr_pallas_apply:
        return "csr_pallas"
    return plan.apply_fn.__name__


def call_launches(plan) -> dict:
    """The kernel launches one call of a plan makes, by counter: a
    kernel plan its kernel (with quantize_int8 for int8, split_bf16 for
    K3), an f32 ELL plan ell_spmm, the int8 ELL and window plans
    quantize_int8, a sum its parts', the torch-ops plans (bf16 ELL,
    windows, bsr_xla) none."""
    if plan.apply_fn is _sum_apply:
        out = {}
        for part in plan.subplans:
            for name, n in call_launches(part).items():
                out[name] = out.get(name, 0) + n
        return out
    if plan.apply_fn in (_ell_int8_apply, _windowed_int8_apply):
        return {"quantize_int8": 1}
    if not kernel_plan(plan):
        return {}
    name = kernel_of(plan)[1]
    out = {name: 1}
    if plan.apply_fn is _int8_pallas_apply:
        out["quantize_int8"] = 1
    if name.endswith("_bf16x3"):
        out["split_bf16"] = 1
    return out


def kernel_plan(plan) -> bool:
    """Whether plan is a leaf that launches a SpMM kernel: a BSR, int8 or
    CSR kernel plan, or an f32 ELL plan (statics[3], its dtype, None or
    float32: the ELL kernel; bf16 runs torch ops)."""
    if plan.apply_fn is _ell_apply:
        return plan.statics[3] in (None, "float32")
    return plan.apply_fn in (_pallas_apply, _int8_pallas_apply, _csr_pallas_apply)


def held_to_plain(plan, errs: list, by_kernel: dict = None):
    """plan (a kernel plan) held to its plain version on every call
    (KERNEL_TOL), its max |kernel - plain| appended to errs and, where
    given, to by_kernel[its kernel's counter]; a values="call" plan's
    call takes its values= to both."""
    name = kernel_of(plan)[1]

    def spmm(h, values=None):
        kw = {} if values is None else {"values": values}
        got = plan(h, **kw)
        want = plan_run(plan, h, plain=True, **kw)
        rel = rel_err(got, want)
        if not torch.isfinite(got).all() or rel >= KERNEL_TOL:
            raise AssertionError(f"{name} vs plain: rel {rel:.3e}")
        err = (got - want).abs().max().item()
        errs.append(err)
        if by_kernel is not None:
            by_kernel.setdefault(name, []).append(err)
        return got

    return spmm


def checked_parts(plan, errs: list, by_kernel: dict = None):
    """plan as the model calls it, a sum (a hybrid, windowed) part by part:
    each kernel part (the hybrid's dense part, an f32 ELL remainder) held
    to its plain version (held_to_plain), the others as they are. The sum
    is the plan's own: first part, then the rest."""
    if plan.apply_fn is not _sum_apply:
        return plan
    parts = [held_to_plain(p, errs, by_kernel) if kernel_plan(p) else p
             for p in plan.subplans]

    def spmm(h):
        out = parts[0](h)
        for part in parts[1:]:
            out = out + part(h)
        return out

    return spmm


def rel64(got, want) -> float:
    """max |got - want| / max |want| of a device answer against a float64
    host reference."""
    got = got.double().cpu().numpy()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def checked_spmm(plan, errs: list, by_kernel: dict = None):
    """plan as a model calls it: a kernel plan (the f32 ELL plans
    included) held to its plain version on every call (held_to_plain), a
    sum's kernel parts (checked_parts), a plan with no kernel as it is."""
    if plan.apply_fn is _sum_apply:
        return checked_parts(plan, errs, by_kernel)
    if not kernel_plan(plan):
        return plan
    return held_to_plain(plan, errs, by_kernel)


def serve_requests(label: str, fn, xs, refs, tag: str, errs: list) -> None:
    """Each request fn(x) on the card against its float64 reference at
    TOL_OF[tag] (max |err| / max |ref|); logs the kernel SpMMs' largest
    max |kernel - plain| where errs collects them."""
    for r, (x, h) in enumerate(zip(xs, refs)):
        n_before = len(errs)
        with torch.no_grad():
            out = fn(x)
        torch.cuda.synchronize()
        if out.shape != h.shape or not torch.isfinite(out).all():
            raise AssertionError(f"{label} request {r}: bad output {tuple(out.shape)}")
        rel = rel64(out, h)
        part = (f"; its {len(errs) - n_before} kernel SpMMs within "
                f"{max(errs[n_before:]):.3e} of their plain version"
                if len(errs) > n_before else "")
        log(f"  {label} request {r}: out {tuple(out.shape)} finite, max |err| / max "
            f"|ref| vs f64 {rel:.3e} (< {TOL_OF[tag]}){part}")
        if not rel < TOL_OF[tag]:
            raise AssertionError(f"{label} request {r}: rel err {rel:.3e}")


def serve_phase(graphs: dict, best: str):
    """Phase 8: the ogbn-arxiv GCN served through spmm_plan's CSR routes
    (SERVE_ROUTES) on the reorder phase's graphs, sym_norm_adjacency:
    the route "auto" took and the scorer's report; SERVE_REQUESTS seeded
    requests per route, each against a float64 host reference at its
    tolerance (TOL_OF); each SpMM's kernels against their plain versions
    (checked_spmm, KERNEL_TOL: a hybrid's dense part and f32 ELL
    remainder, the all-ELL and K10 routes); then SERVE_OPS at F = 128 on the seeded
    check_result operand against spmm_scipy (int8 at INT8_TOL of max
    |ref|). Returns what the counts and the timing need."""
    t0 = time.perf_counter()
    adjs = {"best": sym_norm_adjacency(graphs[best]),
            "original": sym_norm_adjacency(graphs["original"])}
    names = {"best": best, "original": "original"}
    log(f"[serve] GCN {SERVE_DIMS} on {REORDER_DATASET} ({best} and original), "
        f"sym_norm_adjacency: n={adjs['best'].n_rows} nnz={adjs['best'].nnz}, "
        f"{SERVE_REQUESTS} requests a route ({time.perf_counter() - t0:.1f} s)")
    for key, adj in adjs.items():
        t0 = time.perf_counter()
        # an empty kw is the card: the scorer prices by the f32 kernels
        impl, _, report, _ = _auto_impl(adj, 128, SERVE_DIMS[0], {})
        nnzb = calculate_nnzb(adj, 128)
        log(f"  {names[key]}: b=128 nnzb={nnzb} ({nnzb * 128 * 128 * 4 / 2**30:.1f} GiB "
            f"f32, fill {nnzb * 128 * 128 / adj.nnz:.0f}x); impl='auto' routes to "
            f"{impl} ({time.perf_counter() - t0:.1f} s); the scorer's report:")
        for row in report or ():
            log(f"    {row}")
        if impl != "csr_ell":
            raise AssertionError(f"auto on {names[key]} routes to {impl}, expected "
                                 "csr_ell (the kernel pricing's route)")
    gen = torch.Generator().manual_seed(SEED + 20)
    model = GCN(SERVE_DIMS, generator=gen).to(DEV)
    params = [{k: v.detach().cpu().double().numpy() for k, v in p.items()}
              for p in model.params()]
    xs = [seeded((adjs["best"].n_rows, SERVE_DIMS[0]), SEED + 200 + r)
          for r in range(SERVE_REQUESTS)]
    refs = {}
    t0 = time.perf_counter()
    for key in {key for _, key, _, _ in SERVE_ROUTES}:
        refs[key] = [gcn_reference(adjs[key], params, x) for x in xs]
    log(f"  float64 references in {time.perf_counter() - t0:.1f} s (host)")
    xs = [torch.as_tensor(x, device=DEV) for x in xs]
    n_spmm = SERVE_REQUESTS * (len(SERVE_DIMS) - 1)
    plans, plan_secs, expect, kernel_errs = {}, {}, {}, {}
    for label, key, kw, tag in SERVE_ROUTES:
        t0 = time.perf_counter()
        plan = spmm_plan(adjs[key], grad=False, device=DEV, **kw)
        plan_s = time.perf_counter() - t0
        tier = tier_of(plan)
        per_call = call_launches(plan)
        for name, n in per_call.items():
            expect[name] = expect.get(name, 0) + n * n_spmm
        what = ""
        if tier.startswith("hybrid"):
            dense_part = plan.subplans[0]
            what = (f": dense part {kernel_of(dense_part)[0]} "
                    f"{kernel_of(dense_part)[1]} ({dense_part.statics[0]} layout, "
                    f"{dense_part.arrays[2].shape[0]} slots) + ELL remainder")
        log(f"[serve] {label} (spmm_plan({kw}) on {names[key]}): tier {tier}{what}, "
            f"plan {plan_s:.1f} s (host); launches a SpMM {per_call}")
        errs = []
        spmm = checked_spmm(plan, errs, kernel_errs)
        serve_requests(label, lambda x: model(spmm, x), xs, refs[key], tag, errs)
        plans[label] = plan
        plan_secs[label] = plan_s
    # the ELL tiers at op level: the check_result operand (seeded signs of
    # 0.5), against spmm_scipy
    adj = adjs["best"]
    signs = np.random.default_rng(SEED + 13).integers(0, 2, (adj.n_cols, 128))
    x_np = signs.astype(np.float32) - 0.5
    x = torch.as_tensor(x_np, device=DEV)
    want = spmm_scipy(adj, x_np)
    for label, kw in SERVE_OPS:
        kw = dict(kw)
        if kw.pop("calibration", False):
            kw["calibration"] = x_np
        t0 = time.perf_counter()
        plan = spmm_plan(adj, grad=False, device=DEV, **kw)
        plan_s = time.perf_counter() - t0
        for name, n in call_launches(plan).items():
            expect[name] = expect.get(name, 0) + n
        got = plan(x)
        torch.cuda.synchronize()
        if kw.get("dtype") is torch.int8:
            err, gate = rel_err(got, torch.as_tensor(want, device=DEV)), INT8_TOL
            ok = err < gate
        else:
            err, gate = assert_allclose(got, want, msg=label), CHECK_EPS
            ok = True
        log(f"  op {label} F=128 vs spmm_scipy: {err:.3e} (< {gate}); plan "
            f"{plan_s:.1f} s (host)")
        if not ok:
            raise AssertionError(f"op {label}: rel err {err:.3e}")
        if label == "windowed":
            plans["windowed"] = plan
        del plan
    plans["csr_ell"] = spmm_plan(adj, impl="csr_ell", grad=False, device=DEV)
    hyb = _explicit_hybrid(adj, "hybrid", 128, {})
    return {"adj": adj, "model": model, "x": xs[0], "plans": plans,
            "expect": expect, "kernel_errs": kernel_errs, "hybrid": hyb,
            "best": best, "plan_s": plan_secs}


def serve_timing(sp: dict, launched: dict, card_line: str) -> list:
    """The serving phase's times: ms per request of each route beside the
    csr_pallas (K10) request; ms per SpMM at F = 128 of SERVE_TIMED
    beside K10, the PyTorch library call (torch.sparse_csr_tensor @ X,
    cuSPARSE, a yardstick) and the CSR bytes bound; a csr_ell SpMM and an
    "auto" request under torch.profiler (busy share, device time by
    kernel); the hybrid dense parts' kernels beside their plain versions,
    bounds and library calls. Returns the kernels line's rows of those
    dense-part instances."""
    model, x, plans, adj = sp["model"], sp["x"], sp["plans"], sp["adj"]
    req_ms = {}
    with torch.no_grad():
        for label, _, _, _ in SERVE_ROUTES:
            req_ms[label] = cuda_ms(lambda: model(plans[label], x), iters=10)
        for label, ms in req_ms.items():
            log(f"  serve GCN {SERVE_DIMS} request {label:<13} {ms:.3f} ms, "
                f"{ms / req_ms['csr_pallas']:.2f}x the csr_pallas (K10) request "
                f"[{card_line}]")
        F = x.shape[1]
        b_ms, b_by = csr_bound(adj, F)
        want = plans["csr_pallas"](x)
        lib = library_ms("csr", adj, x, want, 10,
                         f"serve torch.sparse_csr_tensor @ X, F={F}")
        k10 = cuda_ms(lambda: plans["csr_pallas"](x), iters=20)
        k10_plain = cuda_ms(lambda: plain_apply(plans["csr_pallas"], x), iters=2, warmup=1)
        for label in SERVE_TIMED:
            p = plans[label]
            ms = k10 if label == "csr_pallas" else cuda_ms(lambda: p(x), iters=20)
            plain = f" (plain {k10_plain:.3f} ms)" if label == "csr_pallas" else ""
            log(f"  serve A @ X, F={F} {label:<12} ({tier_of(p)}) {ms:.4f} ms{plain}, "
                f"{ms / k10:.2f}x K10, library "
                f"{'none' if lib is None else f'{lib:.4f} ms'}, CSR bytes bound "
                f"{b_ms:.4f} ms ({b_by}), max |err| / max |K10| "
                f"{rel_to(p(x), want):.3e} [{card_line}]")
        # where an ELL call's time goes, after the times above
        for label, fn in (("A @ X, F=128 csr_ell", lambda: plans["csr_ell"](x)),
                          ("GCN request auto", lambda: model(plans["auto"], x))):
            busy, detail = device_profile(fn, iters=10)
            if busy is None:
                log(f"  serve {label} under torch.profiler: busy share not "
                    f"measured ({detail})")
                continue
            total = sum(detail.values())
            top = "; ".join(f"{name[:60]} {ms:.4f} ms ({ms / total:.1%})"
                            for name, ms in list(detail.items())[:5])
            log(f"  serve {label} under torch.profiler: card busy {busy:.1%} of "
                f"the span, {total:.4f} ms of device time a call: {top} "
                f"[{card_line}]")
    # the hybrids' dense parts: the kernels' rows
    rows, lib_cache, bsr = [], {}, sp["hybrid"].dense
    for label in ("hybrid", "hybrid int8"):
        dense_part = plans[label].subplans[0]
        kid, name, source, replaces = kernel_of(dense_part)
        row = bsr_row(f"serve {sp['best']} {label} dense part {kid}", bsr, dense_part,
                      x, sp["plan_s"][label], card_line, lib_cache)
        rows.append({"name": f"{kid} {name} b=128 {REORDER_DATASET} {sp['best']} hybrid "
                             f"({bsr.nnzb} dense blocks)",
                     "route": "cuda", "source": source, "replaces": replaces,
                     "launches": launched[name],
                     "max_abs_err": max(sp["kernel_errs"][name]), **row})
    lib_cache.clear()
    # the f32 hybrid's remainder: the ELL kernel's rows at F = 128 and 256
    remainder, rem_csr = plans["hybrid"].subplans[1], sp["hybrid"].remainder
    for F in ELL_ROW_F:
        xe = x if F == x.shape[1] else torch.as_tensor(
            seeded((rem_csr.n_cols, F), SEED + 14), device=DEV)
        label = f"{REORDER_DATASET} {sp['best']} hybrid remainder"
        rows.append(ell_row(label, rem_csr, remainder, xe, launched,
                            sp["kernel_errs"]["ell_spmm"], card_line))
    return rows


def ell_row(label: str, csr: CSR, plan, x, launched: dict, errs: list,
            card_line: str) -> dict:
    """The kernels line's row of the f32 ELL kernel (K11) on plan, the
    ELL plan of csr, at x's width: the kernel held to its plain version
    (the torch-op chunk loop) on x too, its time, the plain version's, the
    CSR bytes bound, the PyTorch library call (cuSPARSE) and the strip
    width; launches and max_abs_err those of the main path's serve phase
    (launched, errs) with x's check added."""
    kid, name, source, replaces = kernel_of(plan)
    F = x.shape[1]
    errs = errs + [check_kernel(plan, x, f"{label} F={F}")]
    want = plan(x)
    lib = library_ms("csr", csr, x, want, 10,
                     f"{label} torch.sparse_csr_tensor @ X, F={F}")
    k_ms = cuda_ms(lambda: plan(x), iters=20)
    p_ms = cuda_ms(lambda: plain_apply(plan, x), iters=2, warmup=1)
    b_ms, b_by = csr_bound(csr, F)
    W = ell_strip_width(csr.n_cols, F, _l2_bytes(0))
    log(f"  {label} {kid} {name} F={F}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), library "
        f"{'none' if lib is None else f'{lib:.4f} ms'}, strips of W={W} "
        f"({-(-F // W)} strips), {csr.nnz} stored entries in {plan.arrays[1].numel()} "
        f"ELL slots, {plan.arrays[-2].numel()} rows split [{card_line}]")
    return {"name": f"{kid} {name} {label} F={F} ({csr.nnz} nonzeros)",
            "route": "cuda", "source": source, "replaces": replaces,
            "launches": launched[name], "max_abs_err": max(errs), "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "strip": W}


def params64(params):
    return tree_map(lambda t: t.detach().cpu().double().numpy(), params)


def sage_reference(adj, params, x) -> np.ndarray:
    h, a64 = x.astype(np.float64), adj.to_scipy().astype(np.float64)
    for i, p in enumerate(params):
        h = (h @ p["self"]["w"] + p["self"]["b"]
             + (a64 @ h) @ p["neigh"]["w"] + p["neigh"]["b"])
        if i < len(params) - 1:
            h = np.maximum(h, 0.0)
    return h


def classifier_reference(adj, params, x, gids, n_graphs: int) -> np.ndarray:
    import scipy.sparse as sps

    h, a64 = x.astype(np.float64), adj.to_scipy().astype(np.float64)
    layers = params["gin"]
    for i, p in enumerate(layers):
        h = (1.0 + p["eps"]) * h + a64 @ h
        h = np.maximum(h @ p["mlp1"]["w"] + p["mlp1"]["b"], 0.0)
        h = h @ p["mlp2"]["w"] + p["mlp2"]["b"]
        if i < len(layers) - 1:
            h = np.maximum(h, 0.0)
    pool = sps.csr_matrix((np.ones(len(gids)), (gids, np.arange(len(gids)))),
                          shape=(n_graphs, len(gids)))
    counts = np.maximum(np.bincount(gids, minlength=n_graphs), 1.0)[:, None]
    return (pool @ h) / counts @ params["head"]["w"] + params["head"]["b"]


def gat_bound(n: int, nnz: int, dims, heads: int) -> tuple:
    """A GAT request's bound: per layer the projection, the two score
    products and the weighted sum over the edges (2 operations a
    multiply-add, f32); the input, the output, the weights and the edge
    ids and row lengths (int64) read or written once."""
    flops, nbytes, d_in = 0.0, 0.0, dims[0]
    for d in dims[1:]:
        flops += 2.0 * (n * d_in * heads * d + 2 * n * heads * d + nnz * heads * d)
        nbytes += 4.0 * (d_in * heads * d + 2 * heads * d)
        d_in = heads * d
    nbytes += 4.0 * n * (dims[0] + dims[-1]) + 8.0 * (2 * nnz + n)
    return bound("f32", flops, nbytes)


def gat_request(model, apply, x):
    with torch.inference_mode():
        return model(apply, x)


def sage_forward(params, spmm, x, masks=None):
    """sage_apply's logits and hidden pre-activations; with masks the
    hidden ReLUs are those fixed 0/1 patterns."""
    zs, h = [], x
    for i, p in enumerate(params):
        z = linear(p["self"], h) + linear(p["neigh"], spmm(h))
        if i == len(params) - 1:
            return z, zs
        zs.append(z)
        h = z * masks[i] if masks is not None else torch.relu(z)


def sage_train_step(adj, dims) -> None:
    """One Adam step of SAGE through the f32 grad plan (K2 on A and on
    Aᵀ): the step-0 gradients within MODEL_GRAD_TOL (max |err| / max |ref|
    a leaf) of the same step through the plain plan at the kernel run's
    ReLU pattern, and the loss after the step below the loss before."""
    plan = spmm_plan(adj, impl="bsr_pallas", block_size=128, device=DEV)
    kids = [kernel_of(p)[1] for p in plan.arrays]
    if kids != ["bsr_spmm_sorted"] * 2:
        raise AssertionError(f"SAGE ddi grad plan runs {kids}, expected K2 both ways")
    n = adj.n_rows
    rng = np.random.default_rng(SEED + 30)
    x = torch.as_tensor(rng.standard_normal((n, dims[0])).astype(np.float32), device=DEV)
    y = torch.as_tensor(rng.integers(0, dims[-1], size=n), device=DEV)
    mask = torch.as_tensor((rng.random(n) < 0.6).astype(np.float32), device=DEV)
    params = init_sage(dims, torch.Generator().manual_seed(SEED + 31), device=DEV)
    with torch.no_grad():  # the kernel run's ReLU pattern
        _, zs = sage_forward(params, plan, x)
    masks = [(z > 0).float() for z in zs]
    plain = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    logits, _ = sage_forward(plain, lambda h: plain_apply(plan, h), x, masks)
    plain_loss = masked_cross_entropy(logits, y, mask)
    plain_loss.backward()
    step, init_state = make_train_step(
        sage_apply, plan, functools.partial(torch.optim.Adam, lr=1e-2))
    state = init_state(params)
    params, state, metrics = step(params, state, x, y, mask)
    torch.cuda.synchronize()
    err = max(((t.grad - r.grad).abs().max() / r.grad.abs().max()).item()
              for t, r in zip(tree_leaves(params), tree_leaves(plain)))
    after = make_eval_step(sage_apply, plan)(params, x, y, mask)["loss"].item()
    loss = metrics["loss"].item()
    log(f"  SAGE ddi Adam step (K2 on A and Aᵀ): loss {loss:.6f} (plain plan "
        f"{plain_loss.item():.6f}), after the step {after:.6f}; step-0 gradients "
        f"within {err:.3e} of the plain plan's at the kernel run's ReLU pattern "
        f"(< {MODEL_GRAD_TOL}, max |err| / max |ref| a leaf)")
    if not err < MODEL_GRAD_TOL:
        raise AssertionError(f"SAGE train: step-0 gradient rel err {err:.3e}")
    if not np.isfinite([loss, after]).all() or not after < loss:
        raise AssertionError(f"SAGE train: loss {loss} -> {after} did not fall")


def models_phase(ddi: CSR, graphs: dict, best: str, op_bsr: BSR, k2_op,
                 x_op, read) -> dict:
    """Phase 8b: the model family at published widths on the card, each
    configuration's run read by `read` (the counts set to 0 just before
    it). SAGE on ogbl-ddi (bsr_pallas f32: K2, int8: K7 + quantize_int8,
    csr_pallas: K10, and one Adam step through the f32 grad plan), SAGE
    on arxiv through impl="auto", the GIN graph classifier on an
    ogbg-molhiv-sized molecule batch (csr_ell, bsr_pallas at b = 32: K1,
    auto), GAT on arxiv's attention pattern through its pattern plan,
    then the ops beside SpMM (dense_block_gemm, both SDDMM tiers,
    csr_to_bsr_on_device). Every request against a float64 reference
    (SAGE, GIN: numpy on the host; GAT: the same function in float64 on
    the card, its segment route), every kernel SpMM against its plain
    version. Returns what the timing needs."""
    mp = {"requests": {}, "errs": {}, "k2_op": k2_op}
    n_req = MODEL_REQUESTS

    def requests_of(n, width, seed):
        return [seeded((n, width), seed + r) for r in range(n_req)]

    # -- SAGE, link-prediction encoder on ddi ------------------------------
    adj = mean_adjacency(ddi)
    dims = SAGE_DDI_DIMS
    model = SAGE(dims, torch.Generator().manual_seed(SEED + 40)).to(DEV)
    p64 = params64(model.params())
    xs = requests_of(adj.n_rows, dims[0], SEED + 400)
    refs = [sage_reference(adj, p64, x) for x in xs]
    xs = [torch.as_tensor(x, device=DEV) for x in xs]
    n_spmm = n_req * (len(dims) - 1)
    log(f"[models] SAGE {dims} on ogbl-ddi (rcmk, mean_adjacency): n={adj.n_rows} "
        f"nnz={adj.nnz}, {n_req} requests a route")
    for label, kw, tag, want_kernel in SAGE_DDI_ROUTES:
        reset_launches()
        plan = spmm_plan(adj, grad=False, device=DEV, **kw)
        if kernel_of(plan)[1] != want_kernel:
            raise AssertionError(f"SAGE ddi {label}: {kernel_of(plan)[1]}, "
                                 f"expected {want_kernel}")
        errs = mp["errs"].setdefault(f"sage ddi {label}", [])
        spmm = checked_spmm(plan, errs)
        serve_requests(f"SAGE ddi {label}", lambda x: model(spmm, x), xs, refs, tag, errs)
        expect = {name: n * n_spmm for name, n in call_launches(plan).items()}
        read(f"models SAGE ddi {label}", expect)
        mp["requests"][f"SAGE ddi {label}"] = (
            functools.partial(model, plan, xs[0]), 10)
    reset_launches()
    sage_train_step(adj, dims)
    # the ReLU pattern's forward (2 SpMMs), the step (2 forward, 1
    # backward: x needs no gradient), the eval's forward (2)
    read("models SAGE ddi train", {"bsr_spmm_sorted": 2 + 3 + 2})
    del xs, refs

    # -- SAGE, node classification on arxiv through auto --------------------
    adj = mean_adjacency(graphs[best])
    dims = SAGE_ARXIV_DIMS
    impl, _, report, _ = _auto_impl(adj, 128, dims[0], {})
    log(f"[models] SAGE {dims} on {REORDER_DATASET} ({best}, mean_adjacency): "
        f"n={adj.n_rows} nnz={adj.nnz}; impl='auto' routes to {impl}; the scorer's "
        "report:")
    for row in report or ():
        log(f"    {row}")
    model = SAGE(dims, torch.Generator().manual_seed(SEED + 41)).to(DEV)
    p64 = params64(model.params())
    xs = requests_of(adj.n_rows, dims[0], SEED + 410)
    t0 = time.perf_counter()
    refs = [sage_reference(adj, p64, x) for x in xs]
    log(f"  float64 references in {time.perf_counter() - t0:.1f} s (host)")
    xs = [torch.as_tensor(x, device=DEV) for x in xs]
    reset_launches()
    plan = spmm_plan(adj, impl="auto", feat_dim=dims[0], grad=False, device=DEV)
    log(f"  tier {tier_of(plan)}; launches a SpMM {call_launches(plan)}")
    errs = mp["errs"].setdefault("sage arxiv auto", [])
    spmm = checked_spmm(plan, errs)
    serve_requests("SAGE arxiv auto", lambda x: model(spmm, x), xs, refs, "f32", errs)
    n_spmm = n_req * (len(dims) - 1)
    read("models SAGE arxiv auto",
         {name: n * n_spmm for name, n in call_launches(plan).items()})
    mp["requests"]["SAGE arxiv auto"] = (functools.partial(model, plan, xs[0]), 5)
    del xs, refs

    # -- the GIN graph classifier on a molecule batch ------------------------
    t0 = time.perf_counter()
    mol, gids = synthetic_molecules(*GIN_MOLECULES, seed=SEED)
    mol = permutate(per_graph_reorder(mol, gids, "rcmk"), mol)
    n_graphs = int(gids.max()) + 1
    dims = GIN_DIMS
    log(f"[models] GIN graph classifier {dims}, 2 classes, on {n_graphs} molecules "
        f"(synthetic_molecules, per-graph rcmk, raw adjacency): n={mol.n_rows} "
        f"nnz={mol.nnz} ({time.perf_counter() - t0:.1f} s host)")
    model = GraphClassifier(dims, 2, torch.Generator().manual_seed(SEED + 42)).to(DEV)
    p64 = params64(model.params())
    xs = requests_of(mol.n_rows, dims[0], SEED + 420)
    t0 = time.perf_counter()
    refs = [classifier_reference(mol, p64, x, gids, n_graphs) for x in xs]
    log(f"  float64 references in {time.perf_counter() - t0:.1f} s (host)")
    xs = [torch.as_tensor(x, device=DEV) for x in xs]
    gids_t = torch.as_tensor(gids, device=DEV)
    n_spmm = n_req * (len(dims) - 1)
    for label, kw in GIN_ROUTES:
        reset_launches()
        plan = spmm_plan(mol, grad=False, device=DEV, **kw)
        tier = tier_of(plan)
        what = (f"{kernel_of(plan)[0]} {kernel_of(plan)[1]}" if tier == "_pallas_apply"
                else tier)
        note = " (expected csr_ell)" if label == "auto" else ""
        log(f"  GIN {label} (spmm_plan({kw})): {what}{note}; launches a SpMM "
            f"{call_launches(plan)}")
        if label == "bsr_pallas b=32" and kernel_of(plan)[1] != "bsr_spmm_flat":
            raise AssertionError(f"GIN b=32 plan runs {kernel_of(plan)[1]}, expected K1")
        errs = mp["errs"].setdefault(f"gin {label}", [])
        spmm = checked_spmm(plan, errs)
        serve_requests(f"GIN {label}", lambda x: model(spmm, x, gids_t, n_graphs),
                       xs, refs, "f32", errs)
        read(f"models GIN {label}",
             {name: n * n_spmm for name, n in call_launches(plan).items()})
        mp["requests"][f"GIN {label}"] = (
            functools.partial(model, plan, xs[0], gids_t, n_graphs), 5)
        if label == "bsr_pallas b=32":
            mp["gin_k1"] = {"plan": plan, "bsr": csr_to_bsr(mol, 32), "x": xs[0],
                            "launches": launches()["bsr_spmm_flat"]}
    del xs, refs

    # -- GAT on arxiv's attention pattern, through its pattern plan ---------
    g = gat_pattern(graphs[best])
    dims = GAT_DIMS
    reset_launches()
    model = GAT(dims, GAT_HEADS, torch.Generator().manual_seed(SEED + 43)).to(DEV)
    t0 = time.perf_counter()
    plan = spmm_plan(g, values="call", device=DEV)
    plan_s = time.perf_counter() - t0
    errs = mp["errs"].setdefault("gat plan", [])
    # every valued call of the checked requests held to its plain version;
    # apply runs the plan as the program does, for the peak and the times
    checked = make_gat_apply(g, GAT_HEADS, device=DEV, plan=held_to_plain(plan, errs))
    apply = make_gat_apply(g, GAT_HEADS, device=DEV, plan=plan)
    edge_gb = g.nnz * GAT_HEADS * max(dims[1:]) * 4 / 1e9
    log(f"[models] GAT {dims}, {GAT_HEADS} heads, on {REORDER_DATASET} ({best}, "
        f"gat_pattern): n={g.n_rows} entries={g.nnz}; pattern plan {tier_of(plan)} "
        f"in {plan_s:.1f} s (host), {plan.arrays[1].numel()} ELL slots; an (entries, "
        f"heads, d) f32 tensor would take {edge_gb:.2f} GB; {n_req} requests under "
        "inference_mode, each valued call against its plain version, each request "
        "against the same function in float64 on the card (its segment route)")
    p64 = tree_map(lambda t: t.detach().double(), model.params())
    xs = [torch.as_tensor(x, device=DEV)
          for x in requests_of(g.n_rows, dims[0], SEED + 430)]
    for r, x in enumerate(xs):
        out = gat_request(model, checked, x)
        with torch.inference_mode():
            want = apply(p64, x.double())
        if out.shape != want.shape or not torch.isfinite(out).all():
            raise AssertionError(f"GAT request {r}: bad output {tuple(out.shape)}")
        rel = ((out.double() - want).abs().max() / want.abs().max()).item()
        log(f"  GAT request {r}: out {tuple(out.shape)} finite, max |err| / max |ref| "
            f"vs float64 on the card {rel:.3e} (< {CHECK_EPS}); valued calls' largest "
            f"max |kernel - plain| so far {max(errs):.3e}")
        if not rel < CHECK_EPS:
            raise AssertionError(f"GAT request {r}: rel err {rel:.3e}")
        del want
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = gat_request(model, apply, xs[0])
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    mp["gat_peak_gb"] = peak_gb
    log(f"  GAT f32 request on the plan: peak device memory {peak_gb:.2f} GB above the "
        f"{base / 1e9:.2f} GB already held (torch.cuda.max_memory_allocated)")
    n_layers = len(dims) - 1
    read("models GAT", {"ell_spmm": n_layers * (n_req + 1)})
    mp["requests"]["GAT arxiv"] = (functools.partial(gat_request, model, apply, xs[0]), 3)
    mp["gat_bound"] = gat_bound(g.n_rows, g.nnz, dims, GAT_HEADS)
    mp["gat_ell"] = {"csr": g, "plan": plan, "errs": errs,
                     "launches": launches()["ell_spmm"]}
    del p64, out, checked
    torch.cuda.empty_cache()

    # -- the ops beside SpMM -------------------------------------------------
    reset_launches()
    mp["ops"] = models_ops(ddi, graphs[best], op_bsr, k2_op, x_op)
    read("models ops", {"bsr_spmm_sorted": 1})
    return mp


def sddmm_block_f64(bsr: BSR, x, y) -> torch.Tensor:
    """The score blocks of bsr's real blocks in float64: x and y padded
    to the block grid, each block's (b, d) @ (d, b)."""
    b, n = bsr.b, bsr.nnzb
    pad = torch.nn.functional.pad
    xb = pad(x.double(), (0, 0, 0, bsr.n_block_rows * b - x.shape[0]))
    yb = pad(y.double(), (0, 0, 0, bsr.n_block_cols * b - y.shape[0]))
    rows = torch.as_tensor(bsr.block_rows[:n].astype(np.int64), device=x.device)
    cols = torch.as_tensor(bsr.block_cols[:n].astype(np.int64), device=x.device)
    xg = xb.reshape(-1, b, x.shape[1])[rows]
    yg = yb.reshape(-1, b, y.shape[1])[cols]
    return torch.bmm(xg, yg.transpose(1, 2))


def models_ops(ddi: CSR, arxiv: CSR, op_bsr: BSR, k2_op, x_op) -> dict:
    """dense_block_gemm at bench.py's op shape (the block list shuffled)
    against f32 K2; SDDMM's element tier on arxiv (d = 128) and its block
    tier on ddi's blocks (d = 256, f32 and bf16) against float64;
    csr_to_bsr_on_device on arxiv at b = 32 against the host conversion,
    at the count and below it. Returns what the timing needs."""
    out = {}
    F = x_op.shape[1]
    order = np.random.default_rng(SEED + 50).permutation(op_bsr.nnzb)
    gemm_args = (torch.as_tensor(op_bsr.block_rows[order], device=DEV),
                 torch.as_tensor(op_bsr.block_cols[order], device=DEV),
                 torch.as_tensor(op_bsr.blocks[order], device=DEV),
                 x_op.reshape(op_bsr.n_block_cols, op_bsr.b, F), op_bsr.n_block_rows)
    got = dense_block_gemm(*gemm_args, device=DEV).reshape(-1, F)[: op_bsr.shape[0]]
    want = k2_op(x_op)
    torch.cuda.synchronize()
    rel = rel_err(got, want)
    log(f"[models] op dense_block_gemm ({op_bsr.nnzb} blocks of {op_bsr.b}, shuffled, "
        f"F={F}) vs f32 K2: max |err| / max |K2| {rel:.3e} (< {KERNEL_TOL})")
    if not rel < KERNEL_TOL:
        raise AssertionError(f"dense_block_gemm vs K2: rel {rel:.3e}")
    out["gemm"] = gemm_args
    del got, want

    d = SDDMM_ARXIV_D
    x = torch.as_tensor(seeded((arxiv.n_rows, d), SEED + 51), device=DEV)
    y = torch.as_tensor(seeded((arxiv.n_cols, d), SEED + 52), device=DEV)
    plan = sddmm_plan(arxiv, device=DEV)
    e = plan(x, y)
    rows = torch.as_tensor(arxiv.row_ids().astype(np.int64), device=DEV)
    e64 = (x.double()[rows] * y.double()[plan.arrays[1]]).sum(-1)
    rel = ((e.double() - e64).abs().max() / e64.abs().max()).item()
    log(f"[models] op sddmm element tier on {REORDER_DATASET} ({arxiv.nnz} edges, "
        f"d={d}): {e.dtype} scores, max |err| / max |ref| vs float64 {rel:.3e} "
        f"(< {CHECK_EPS})")
    if e.dtype != torch.float32 or not rel < CHECK_EPS:
        raise AssertionError(f"sddmm element: {e.dtype}, rel {rel:.3e}")
    out["sddmm"] = (arxiv, plan, x, y)
    del e, e64, rows

    bsr = csr_to_bsr(ddi, 128)
    d = SDDMM_DDI_D
    args = (bsr.block_rows[: bsr.nnzb], bsr.block_cols[: bsr.nnzb], 128,
            ddi.n_rows, ddi.n_cols)
    bplan = sddmm_block_plan(*args, device=DEV)
    x = torch.as_tensor(seeded((ddi.n_rows, d), SEED + 53), device=DEV)
    y = torch.as_tensor(seeded((ddi.n_cols, d), SEED + 54), device=DEV)
    s64 = sddmm_block_f64(bsr, x, y)
    out["sddmm_block"] = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        xd, yd = x.to(dtype), y.to(dtype)
        s = bplan(xd, yd)
        rel = ((s.double() - s64).abs().max() / s64.abs().max()).item()
        log(f"[models] op sddmm block tier on ogbl-ddi ({bsr.nnzb} blocks of 128, "
            f"d={d}) {tag}: {s.dtype} score blocks, max |err| / max |ref| vs float64 "
            f"{rel:.3e} (< {TOL_OF[tag]})")
        if s.dtype != torch.float32 or s.shape != (bsr.nnzb, 128, 128) \
                or not rel < TOL_OF[tag]:
            raise AssertionError(f"sddmm block {tag}: {s.dtype}, rel {rel:.3e}")
        out["sddmm_block"][tag] = (bsr, bplan, xd, yd)
    del s, s64

    b = CONVERT_B
    t0 = time.perf_counter()
    host = csr_to_bsr(arxiv, b)
    host_s = time.perf_counter() - t0
    nbc = -(-arxiv.n_cols // b)
    rows_t = torch.as_tensor(arxiv.row_ids(), device=DEV)
    cols_t = torch.as_tensor(np.asarray(arxiv.indices, np.int32), device=DEV)
    count = int(count_nnzb_device(rows_t, cols_t, nbc, b, device=DEV))
    t0 = time.perf_counter()
    dev_bsr = csr_to_bsr_on_device(arxiv, b, device=DEV)
    dev_s = time.perf_counter() - t0
    same = all(np.array_equal(getattr(dev_bsr, k), getattr(host, k))
               for k in ("block_rows", "block_cols", "blocks"))
    log(f"[models] op csr_to_bsr_on_device on {REORDER_DATASET} at b={b}: "
        f"count_nnzb_device {count}, host {host.nnzb}; {dev_bsr.nnzb} blocks "
        f"({host.blocks.nbytes / 1e9:.2f} GB), equal to the host csr_to_bsr's bit "
        f"for bit: {same}; first call {dev_s:.2f} s, host conversion {host_s:.2f} s")
    if count != host.nnzb or dev_bsr.nnzb != host.nnzb or not same:
        raise AssertionError("csr_to_bsr_on_device differs from the host conversion")
    del dev_bsr
    cap = host.nnzb - CONVERT_SHORT
    cut = csr_to_bsr_on_device(arxiv, b, nnzb_max=cap, device=DEV)
    keep = cap - 1
    ok = (cut.nnzb == host.nnzb and cut.blocks.shape[0] == cap
          and all(np.array_equal(getattr(cut, k)[:cap], getattr(host, k)[:cap])
                  for k in ("block_rows", "block_cols", "blocks")))
    log(f"  nnzb_max={cap} ({CONVERT_SHORT} below the count): nnzb {cut.nnzb} (the "
        f"true count), slots 0..{keep} the host's first {cap} blocks bit for bit, the "
        f"{CONVERT_SHORT} blocks past them dropped: {ok}")
    if not ok:
        raise AssertionError("csr_to_bsr_on_device: the dropped-block contract broke")
    del cut
    out["convert"] = {"csr": arxiv, "host": host, "host_s": host_s,
                      "inputs": (rows_t, cols_t, None if arxiv.data is None else
                                 torch.as_tensor(np.asarray(arxiv.data), device=DEV))}
    torch.cuda.empty_cache()
    return out


def models_timing(mp: dict, card_line: str) -> list:
    """The models phase's times: ms per request of each model and route;
    dense_block_gemm beside f32 K2 and its bound; SDDMM (both tiers)
    beside its bound and, for the element tier, the library call
    (torch.sparse.sampled_addmm, cuSPARSE's SDDMM); csr_to_bsr_on_device
    beside the host conversion and its bytes bound; a GAT request under
    torch.profiler. Returns the kernels line's row of K1 at b = 32 on the
    molecule batch."""
    t_phase = time.perf_counter()
    with torch.no_grad():
        for label, (fn, iters) in mp["requests"].items():
            log(f"  models request {label:<22} {cuda_ms(fn, iters=iters):.3f} ms "
                f"[{card_line}]")
    log(f"  models request GAT arxiv: bound {mp['gat_bound'][0]:.3f} ms "
        f"({mp['gat_bound'][1]}), library none (PyTorch has no GAT call); peak "
        f"device memory {mp['gat_peak_gb']:.2f} GB above what was held")
    ops = mp.pop("ops")
    rows, cols, blocks, dense_blk, nbr = ops.pop("gemm")
    nnzb, b, F = blocks.shape[0], blocks.shape[1], dense_blk.shape[2]
    k2 = mp["k2_op"]
    x_op = dense_blk.reshape(-1, F)
    g_ms = cuda_ms(lambda: dense_block_gemm(rows, cols, blocks, dense_blk, nbr,
                                             device=DEV), iters=3)
    k_ms = cuda_ms(lambda: k2(x_op), iters=3)
    nbytes = nnzb * (b * b * 4 + 8) + x_op.numel() * 4 + nbr * b * F * 4
    gb = bound("f32", 2.0 * nnzb * b * b * F, nbytes)
    log(f"  models op dense_block_gemm ({nnzb} blocks of {b}, F={F}) {g_ms:.3f} ms, "
        f"f32 K2 on the same blocks {k_ms:.3f} ms ({g_ms / k_ms:.2f}x), bound "
        f"{gb[0]:.3f} ms ({gb[1]}); library: the op phase's f32 "
        f"torch.sparse_bsr_tensor @ X line [{card_line}]")
    del rows, cols, blocks, dense_blk
    torch.cuda.empty_cache()

    csr, plan, x, y = ops.pop("sddmm")
    nnz, d = csr.nnz, x.shape[1]
    e_ms = cuda_ms(lambda: plan(x, y), iters=10)
    eb = bound("f32", 2.0 * nnz * d, nnz * 16 + (x.numel() + y.numel()) * 4 + nnz * 4)
    lib = sampled_addmm_ms(csr, x, y, plan(x, y))
    log(f"  models op sddmm element tier ({nnz} edges, d={d}) {e_ms:.3f} ms, bound "
        f"{eb[0]:.4f} ms ({eb[1]}), library "
        f"{'none' if lib is None else f'{lib:.3f} ms'} [{card_line}]")
    mp["sddmm_ms"] = {"element": (e_ms, eb, lib)}
    del plan, x, y
    for tag, (bsr, bplan, xd, yd) in ops.pop("sddmm_block").items():
        s_ms = cuda_ms(lambda: bplan(xd, yd), iters=10)
        e = ELEM_BYTES[tag]
        sb = bound(tag, 2.0 * bsr.nnzb * bsr.b * bsr.b * xd.shape[1],
                   bsr.nnzb * 16 + (xd.numel() + yd.numel()) * e
                   + bsr.nnzb * bsr.b * bsr.b * 4)
        log(f"  models op sddmm block tier {tag} ({bsr.nnzb} blocks of {bsr.b}, "
            f"d={xd.shape[1]}) {s_ms:.3f} ms, bound {sb[0]:.4f} ms ({sb[1]}), library "
            f"none (torch.sparse.sampled_addmm takes CSR only) [{card_line}]")
        mp["sddmm_ms"][tag] = (s_ms, sb, None)

    cv = ops.pop("convert")
    host, rows_t, cols_t, vals_t = cv["host"], *cv["inputs"]
    csr = cv["csr"]
    b = host.b
    nbr, nbc = host.n_block_rows, host.n_block_cols
    c_ms = cuda_ms(lambda: csr_to_bsr_device(rows_t, cols_t, vals_t, nbr, nbc, b,
                                             host.nnzb, device=DEV), iters=3, warmup=1)
    t0 = time.perf_counter()
    csr_to_bsr_on_device(csr, b, device=DEV)
    whole_s = time.perf_counter() - t0
    cb = bound("f32", 0.0, csr.nnz * 12 + host.nnzb * (b * b * 4 + 8))
    lib = to_sparse_bsr_ms(csr, b)
    log(f"  models op csr_to_bsr_on_device ({REORDER_DATASET}, b={b}, {host.nnzb} "
        f"blocks): on the card {c_ms:.2f} ms, the whole call (counting, copies to and "
        f"from the card) {whole_s:.3f} s, host csr_to_bsr {cv['host_s']:.3f} s "
        f"({cv['host_s'] / whole_s:.1f}x the whole call), bound {cb[0]:.3f} ms "
        f"({cb[1]}), library {'none' if lib is None else f'{lib:.2f} ms'} "
        f"[{card_line}]")
    mp["convert_ms"] = (c_ms, whole_s, cv["host_s"], cb, lib)
    del host, rows_t, cols_t, vals_t, cv
    torch.cuda.empty_cache()

    busy, detail = device_profile(mp["requests"]["GAT arxiv"][0], iters=2)
    if busy is None:
        log(f"  models GAT request under torch.profiler: busy share not measured "
            f"({detail})")
    else:
        total = sum(detail.values())
        top = "; ".join(f"{name[:60]} {ms:.3f} ms ({ms / total:.1%})"
                        for name, ms in list(detail.items())[:6])
        log(f"  models GAT request under torch.profiler: card busy {busy:.1%} of the "
            f"span, {total:.3f} ms of device time a request: {top} [{card_line}]")

    ge = mp.pop("gat_ell")
    rows = [call_values_row(ge, GAT_HEADS * d, card_line) for d in (GAT_DIMS[1], GAT_DIMS[-1])]
    k1 = mp.pop("gin_k1")
    kid, name, source, replaces = kernel_of(k1["plan"])
    row = bsr_row("models GIN molecules K1", k1["bsr"], k1["plan"], k1["x"], 0.0,
                  card_line, {})
    errs = mp["errs"]["gin bsr_pallas b=32"]
    log(f"[models] timing in {time.perf_counter() - t_phase:.1f} s")
    return rows + [{"name": f"{kid} {name} b=32 molecules rcmk ({k1['bsr'].nnzb} "
                            f"blocks, GIN, F={k1['x'].shape[1]})",
                    "route": "cuda", "source": source, "replaces": replaces,
                    "launches": k1["launches"], "max_abs_err": max(errs), **row}]


def call_values_row(ge: dict, F: int, card_line: str) -> dict:
    """The kernels line's row of the ELL kernel (K11) with call values on
    the GAT's pattern plan at F = GAT_HEADS x d, seeded (n, F) operand and
    (GAT_HEADS, nnz) values: held to its plain version (the chunk loop on
    the scattered values), its time, the plain version's, the bytes bound
    (an int32 column and GAT_HEADS f32 values an entry, the row pointer,
    the operand and the output, each once), cuSPARSE on each head (a
    torch.sparse_csr_tensor @ X_h a head, the heads' times added) and the
    strip width; launches those of the models phase's GAT run, max_abs_err
    its valued calls' with this check added."""
    csr, plan, H = ge["csr"], ge["plan"], GAT_HEADS
    kid, name, source, replaces = kernel_of(plan)
    M_, K = csr.shape
    D = F // H
    x = torch.as_tensor(seeded((K, F), SEED + 15 + F), device=DEV)
    v = torch.as_tensor(np.random.default_rng(SEED + 16 + F).random(
        (H, csr.nnz), dtype=np.float32), device=DEV)
    label = f"GAT {REORDER_DATASET} gat_pattern call values {H} heads F={F}"
    got = plan(x, values=v)
    want = plan_run(plan, x, plain=True, values=v)
    rel = rel_err(got, want)
    log(f"  {label} {kid} {name} vs plain: max |err| / max |plain| {rel:.3e} "
        f"(< {KERNEL_TOL})")
    if not torch.isfinite(got).all() or rel >= KERNEL_TOL:
        raise AssertionError(f"{label}: rel err {rel:.3e} >= {KERNEL_TOL}")
    errs = ge["errs"] + [(got - want).abs().max().item()]
    del want
    k_ms = cuda_ms(lambda: plan(x, values=v), iters=20)
    p_ms = cuda_ms(lambda: plan_run(plan, x, plain=True, values=v), iters=2, warmup=1)
    nbytes = csr.nnz * (4 + 4 * H) + (M_ + 1) * 8 + K * F * 4 + M_ * F * 4
    b_ms, b_by = bound("f32", 2.0 * csr.nnz * F, nbytes)
    lib = None
    try:
        with warnings.catch_warnings():  # "sparse ... support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            crow = torch.as_tensor(csr.indptr.astype(np.int64), device=DEV)
            col = torch.as_tensor(csr.indices.astype(np.int64), device=DEV)
            heads = [torch.sparse_csr_tensor(crow, col, v[h], csr.shape,
                                             check_invariants=False) for h in range(H)]
            xh = [x[:, h * D:(h + 1) * D].contiguous() for h in range(H)]

            def library():
                return [a @ b for a, b in zip(heads, xh)]

            lib_rel = rel_to(torch.cat(library(), 1), got)
            lib = cuda_ms(library, iters=10)
        log(f"  library {label} torch.sparse_csr_tensor @ X_h on each head: "
            f"{lib:.4f} ms, max |err| / max |kernel| {lib_rel:.3e}")
    except Exception as e:  # the yardstick only: record PyTorch's refusal
        log(f"  library {label}: none ({type(e).__name__}: "
            f"{str(e).splitlines()[0][:200]})")
    W = ell_strip_width(K, D, _l2_bytes(0))
    log(f"  {label} {kid} {name}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), library {'none' if lib is None else f'{lib:.4f} ms'}, "
        f"strips of W={W} inside each head of {D} ({-(-D // W)} a head), {csr.nnz} "
        f"entries in {plan.arrays[1].numel()} ELL slots, {plan.arrays[-2].numel()} rows "
        f"split [{card_line}]")
    return {"name": f"{kid} {name} {label} ({csr.nnz} nonzeros)",
            "route": "cuda", "source": source, "replaces": replaces,
            "launches": ge["launches"], "max_abs_err": max(errs), "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "strip": W}


def sampled_addmm_ms(csr: CSR, x, y, want):
    """torch.sparse.sampled_addmm (cuSPARSE's SDDMM) on the CSR pattern,
    a yardstick: ms, or None where PyTorch refuses the call."""
    try:
        with warnings.catch_warnings():  # "sparse ... support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            pattern = torch.sparse_csr_tensor(
                torch.as_tensor(csr.indptr.astype(np.int64), device=DEV),
                torch.as_tensor(csr.indices.astype(np.int64), device=DEV),
                torch.zeros(csr.nnz, device=DEV), csr.shape, check_invariants=False)
            yt = y.T.contiguous()
            fn = lambda: torch.sparse.sampled_addmm(pattern, x, yt, beta=0.0)  # noqa: E731
            got = fn().values()
        torch.cuda.synchronize()
    except Exception as e:  # the yardstick only: record PyTorch's refusal
        log(f"  library torch.sparse.sampled_addmm: none ({type(e).__name__}: "
            f"{str(e).splitlines()[0][:200]})")
        return None
    ms = cuda_ms(fn, iters=10)
    log(f"  library torch.sparse.sampled_addmm: {ms:.3f} ms, max |err| / max |port| "
        f"{rel_to(got, want):.3e}")
    return ms


def to_sparse_bsr_ms(csr: CSR, b: int):
    """torch.Tensor.to_sparse_bsr of the CSR tensor on the card, a
    yardstick: ms, or None where PyTorch refuses the call."""
    try:
        grid = tuple(-(-n // b) * b for n in csr.shape)  # its blocks must tile it
        indptr = np.concatenate([csr.indptr, np.full(grid[0] - csr.shape[0],
                                                     csr.indptr[-1])])
        with warnings.catch_warnings():  # "sparse ... support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            a = torch.sparse_csr_tensor(
                torch.as_tensor(indptr.astype(np.int64), device=DEV),
                torch.as_tensor(csr.indices.astype(np.int64), device=DEV),
                torch.as_tensor(csr.values(), device=DEV), grid,
                check_invariants=False)
            # one call, timed: at arxiv's size it takes seconds on an H100
            ms = cuda_ms(lambda: a.to_sparse_bsr((b, b)), iters=1, warmup=0)
    except Exception as e:  # the yardstick only: record PyTorch's refusal
        log(f"  library to_sparse_bsr: none ({type(e).__name__}: "
            f"{str(e).splitlines()[0][:200]})")
        return None
    return ms


# -- phase 8c: the bench harness, the tuner and the profiler ------------------


def bench_sweep(name: str, out_dir: Path) -> list:
    """`python -m spmm_denseblock_tpu_torch.bench <name> --quick` in this
    process (its record lines kept out of the log); returns the records,
    each error-free and one a case of the quick grid."""
    path = out_dir / f"{name}.jsonl"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = sweeps.main([name, "--quick", "--device", DEV, "--out", str(path)])
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    bad = [r["error"] for r in recs if "error" in r]
    if rc != 0 or bad:
        raise AssertionError(f"bench {name} --quick: rc {rc}, errors {bad}")
    if len(recs) != BENCH_QUICK_CASES[name]:
        raise AssertionError(f"bench {name} --quick: {len(recs)} records, expected "
                             f"{BENCH_QUICK_CASES[name]}")
    return recs


def bench_phase(op_bsr: BSR, k2_op, x_op, graphs: dict, card_line: str) -> dict:
    """Phase 8c: the port's bench harness, sweep CLI, tuner and profiler
    on the card (see the module docstring), k2_op the f32 op plan (K2)
    and graphs the reorder phase's. Returns what it measured."""
    p, b, F = BENCH_OP
    out_dir = ROOT / "build" / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    bp = {}
    torch.cuda.empty_cache()
    # a. the harness at bench.py's op shape against cuda_ms on the same
    # plan (the f32 op plan: K2 on the sorted layout) and operand
    t0 = time.perf_counter()
    col = spmm_plan(op_bsr, impl="bsr_pallas", grad=False, operand_layout="col",
                    device=DEV)
    xt = x_op.T.contiguous()
    flops = 2.0 * op_bsr.nnzb * b * b * F
    for transb, plan, x in ((0, k2_op, x_op), (1, col, xt)):
        rec = bench_synthetic_bsr(p, b, F, impl="bsr_pallas", transb=transb, device=DEV)
        with torch.no_grad():
            ev = cuda_ms(lambda: plan(x), iters=20)
        gf = flops / (rec["ms"] / 1e3) / 1e9
        log(f"  bench synthetic_bsr p={p} b={b} F={F} transb={transb}: nnzb "
            f"{rec['nnzb']}, {rec['ms']:.4f} ms (min {rec['ms_min']:.4f}, max "
            f"{rec['ms_max']:.4f} of {rec['repeats']} repeats), {rec['gflops']:.1f} "
            f"GFLOP/s, plan {rec['plan_s']:.2f} s; cuda_ms on the same plan "
            f"{ev:.4f} ms ({rec['ms'] / ev:.4f}x) [{card_line}]")
        if rec["nnzb"] != op_bsr.nnzb:
            raise AssertionError(f"bench: nnzb {rec['nnzb']} != {op_bsr.nnzb}")
        if abs(rec["ms"] - ev) > BENCH_TIMER_TOL * ev:
            raise AssertionError(f"bench transb={transb}: {rec['ms']:.4f} ms is not "
                                 f"within {BENCH_TIMER_TOL:.0%} of cuda_ms {ev:.4f}")
        if abs(rec["gflops"] - gf) > 1e-9 * gf:
            raise AssertionError(f"bench: gflops {rec['gflops']} != 2 nnzb b^2 F / t {gf}")
        bp[f"op transb={transb}"] = (rec, ev)
    # its answer on the first block-rows against spmm_scipy (the dense
    # matrix of all 1,024 would take 68 GB), and the column-major plan's
    # bit for bit against the row plan's (g)
    nb = BENCH_CHECK_BLOCK_ROWS
    keep = op_bsr.block_rows[:op_bsr.nnzb] < nb
    sub = BSR.from_parts(op_bsr.block_rows[:op_bsr.nnzb][keep],
                         op_bsr.block_cols[:op_bsr.nnzb][keep],
                         op_bsr.blocks[:op_bsr.nnzb][keep], (nb * b, op_bsr.shape[1]), b)
    with torch.no_grad():
        row_out = k2_op(x_op)
        col_out = col(xt)
    conf = conformance_fields(row_out[:nb * b], spmm_scipy(sub, x_op.cpu().numpy()),
                              "float32")
    log(f"  bench op answer, first {nb} block-rows vs spmm_scipy: {conf}")
    if not conf["gate_ok"]:
        raise AssertionError(f"bench op answer: {conf}")
    if not torch.equal(col_out, row_out):
        raise AssertionError("operand_layout='col' differs from the row plan")
    log(f"  bench operand_layout='col' (B^T, {tuple(xt.shape)}) equals the row "
        f"plan bit for bit")
    del col, xt, row_out, col_out
    bp["op_s"] = time.perf_counter() - t0
    # b. the sweep CLI's quick grids
    t0 = time.perf_counter()
    for name in ("bsrmm", "csrmm", "graph"):
        for r in bench_sweep(name, out_dir):
            what = " ".join(f"{k}={r[k]}" for k in ("dataset", "strategy", "p", "b",
                                                   "dim", "impl", "transb") if k in r)
            log(f"  bench {name} --quick {what}: {r['ms']:.4f} ms, "
                f"{r['gflops']:.2f} GFLOP/s [{card_line}]")
            bp[f"{name} {what}"] = r["ms"]
    bp["sweeps_s"] = time.perf_counter() - t0
    # c. bench_graph on the arxiv stand-in under rcmk at F = 128
    t0 = time.perf_counter()
    for impl in ("hybrid", "csr_pallas"):
        r = bench_graph("ogbn-arxiv", "rcmk", 128, 128, impl=impl, scale=BENCH_SCALE,
                        device=DEV)
        extra = (f", dense_nnzb {r['dense_nnzb']}, remainder nnz {r['remainder_nnz']}"
                 if impl == "hybrid" else "")
        log(f"  bench graph ogbn-arxiv rcmk b=128 F=128 {impl}: {r['ms']:.4f} ms "
            f"(min {r['ms_min']:.4f}, max {r['ms_max']:.4f}), {r['gflops']:.1f} "
            f"GFLOP/s, plan {r['plan_s']:.2f} s{extra} [{card_line}]")
        bp[f"graph {impl}"] = r
    # d. one GCN training step at bench_train_step's defaults
    r = bench_train_step(scale=BENCH_SCALE, device=DEV)
    log(f"  bench train_step {r['dataset']} {r['strategy']} {r['dims']} "
        f"{r['impl']}: {r['ms_per_step']:.3f} ms a step, "
        f"{r['edges_per_s'] / 1e9:.3f} G edges/s [{card_line}]")
    bp["train_step"] = r
    bp["graph_s"] = time.perf_counter() - t0
    # e. spmm_tune on arxiv under rcmk, F = 128, beside auto's route
    t0 = time.perf_counter()
    adj = sym_norm_adjacency(graphs["rcmk"])
    x = torch.as_tensor(seeded((adj.n_cols, 128), SEED + 70), device=DEV)
    want = spmm_scipy(adj, x.cpu().numpy())
    bp["tune"] = {}
    for bs in BENCH_TUNE_B:
        block_bytes = calculate_nnzb(adj, bs) * bs * bs * 4
        cands = [c for c in BENCH_TUNE
                 if not c.startswith("bsr") or block_bytes <= BENCH_BLOCK_BUDGET]
        skipped = [c for c in BENCH_TUNE if c not in cands]
        best, report = spmm_tune(adj, x, candidates=cands, block_size=bs,
                                 grad=False, device=DEV)
        errors = {k: v["error"] for k, v in report.items()
                  if k != "best" and "error" in v}
        if any("out of memory" not in e for e in errors.values()):
            raise AssertionError(f"spmm_tune b={bs}: {errors}")
        with torch.no_grad():
            err = conformance_fields(best(x), want, "float32")
        if not err["gate_ok"]:
            raise AssertionError(f"spmm_tune b={bs} best {report['best']}: {err}")
        route = _auto_impl(adj, bs, 128, {})[0]
        table = ", ".join(f"{k} {v['ms']:.4f} ms" if "ms" in v else f"{k} {v['error']}"
                          for k, v in report.items() if k != "best")
        why = (f" (f32 blocks {block_bytes / 1e9:.2f} GB, over auto's "
               f"{BENCH_BLOCK_BUDGET >> 30} GiB guard)" if skipped else "")
        log(f"  bench spmm_tune arxiv rcmk b={bs} F=128: {table}; best "
            f"{report['best']} (max rel err {err['max_rel_err']:.2e}); auto routes to "
            f"{route}; not built: {skipped or 'none'}{why} [{card_line}]")
        bp["tune"][bs] = (report, route, skipped, block_bytes)
        del best
        torch.cuda.empty_cache()
    bp["tune_s"] = time.perf_counter() - t0
    # f. auto with tune_with= where the scorer's margin is thin: the serve
    # graph (gorder) at b = 128, priced by the card's f32 kernels (the
    # hybrid at auto_threshold, no dense block, ties pure ELL)
    t0 = time.perf_counter()
    adj = sym_norm_adjacency(graphs["gorder"])
    x = torch.as_tensor(seeded((adj.n_cols, 128), SEED + 71), device=DEV)
    kw = {"bsr_bytes_budget": BENCH_THIN_BUDGET, "grad": False, "device": DEV}
    scored = _auto_impl(adj, 128, None, dict(kw))[2]
    finalists = _thin_margin_finalists(scored)
    if finalists is None:
        raise AssertionError(f"tune_with case: the margin is not thin: {scored}")
    _, report = spmm_tune(adj, x, candidates=finalists, block_size=128,
                          grad=False, device=DEV)
    plan = spmm_plan(adj, impl="auto", tune_with=x, **kw)
    with torch.no_grad():
        err = conformance_fields(plan(x), spmm_scipy(adj, x.cpu().numpy()), "float32")
    if not err["gate_ok"]:
        raise AssertionError(f"tune_with plan: {err}")
    scores = {r["thr"]: r["score"] for r in scored if r.get("score") is not None}
    log(f"  bench tune_with arxiv gorder b=128 F=128, budget "
        f"{BENCH_THIN_BUDGET >> 20} MiB: scores {scores}; finalists {finalists}; "
        f"measured {report}; auto(tune_with) built {tier_of(plan)} (max rel err "
        f"{err['max_rel_err']:.2e}) [{card_line}]")
    bp["tune_with"] = (finalists, report, tier_of(plan))
    del plan
    bp["tune_with_s"] = time.perf_counter() - t0
    # h. a profiler trace of one op-shape call; the harness's op record on
    # the H100 roofline
    t0 = time.perf_counter()
    trace_dir = out_dir / "trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    with torch.no_grad(), trace(str(trace_dir)):
        k2_op(x_op)
    (path,) = trace_dir.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    entry = kernel_of(k2_op)[1]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    if f"sdb_{entry}" not in {e.get("name") for e in events}:
        raise AssertionError(f"trace {path.name} does not name sdb_{entry}")
    rec = bp["op transb=0"][0]
    roof = roofline(flops, rec["bytes"], rec["ms"] / 1e3, PEAK_OPS_S["f32"], HBM_BYTES_S)
    log(f"  bench trace {path.relative_to(ROOT)} ({path.stat().st_size} bytes): "
        f"names sdb_{entry}; device kernels {sorted(k[:60] for k in kernels)}")
    log(f"  bench roofline of the op record (f32 FFMA peak {PEAK_OPS_S['f32']:.3g}, "
        f"{HBM_BYTES_S:.3g} B/s): {roof} [{card_line}]")
    if not roof["frac_of_roofline"] <= BENCH_ROOF_MAX:
        raise AssertionError(f"frac_of_roofline {roof['frac_of_roofline']}")
    bp["roofline"] = roof
    bp["device_info"] = device_info(DEV)
    log(f"  bench device_info: {bp['device_info']}")
    bp["trace_s"] = time.perf_counter() - t0
    log("  bench phase seconds: " + ", ".join(
        f"{k[:-2]} {v:.1f}" for k, v in bp.items() if k.endswith("_s")))
    return bp


def bsr_f64(bsr: BSR, x) -> torch.Tensor:
    """A @ x in float64 on the card from bsr's real blocks, summed in
    chunks of DEFAULT_F64_CHUNK blocks; (n_rows, F)."""
    b, n, F = bsr.b, bsr.nnzb, x.shape[1]
    xb = torch.nn.functional.pad(x.double(), (0, 0, 0, bsr.n_block_cols * b - x.shape[0]))
    xb = xb.reshape(-1, b, F)
    rows = torch.as_tensor(bsr.block_rows[:n].astype(np.int64), device=x.device)
    cols = torch.as_tensor(bsr.block_cols[:n].astype(np.int64), device=x.device)
    out = torch.zeros(bsr.n_block_rows, b, F, dtype=torch.float64, device=x.device)
    for s0 in range(0, n, DEFAULT_F64_CHUNK):
        s1 = min(n, s0 + DEFAULT_F64_CHUNK)
        blk = torch.as_tensor(bsr.blocks[s0:s1], device=x.device).double()
        out.index_add_(0, rows[s0:s1], torch.bmm(blk, xb[cols[s0:s1]]))
    return out.reshape(-1, F)[: bsr.shape[0]]


def int_csr(csr: CSR, seed: int) -> CSR:
    """csr's pattern with integer values of magnitude <= 16 (exact in
    bf16)."""
    vals = np.random.default_rng(seed).integers(-16, 17, size=csr.nnz)
    return CSR(csr.indptr, csr.indices, vals.astype(np.float32), csr.shape)


def k10_default_geometry(shape) -> str:
    """The one-bf16-pass kernel's geometry on a (K, F) operand from the
    cast (16-byte aligned), as csr_bf16_spmm in csrc/csr_spmm.cu picks
    it: csr_bf16_strip_width's strips; V columns a load (8 where F % 8 ==
    0, else 4 where F % 4 == 0, else 1) and J loads a lane (1 at V = 8,
    else 256 / (32 V)); the fewest of 4, 8, 16, 32 lanes that cover a
    strip, so 32 / lanes segments a warp; a precision="default" plan's
    segments longest first (row_segments)."""
    K, F = shape
    W = csr_bf16_strip_width(K, F, _l2_bytes(0))
    V = 8 if F % 8 == 0 else 4 if F % 4 == 0 else 1
    J = 1 if V == 8 else CSR_BF16_MAX_STRIP // (32 * V)
    lanes = next(L for L in (4, 8, 16, 32) if L * V * J >= min(W, F))
    return (f"strips of W={W} (F / W = {-(-F // W)}), {lanes} lanes a nonzero "
            f"({V} columns a load), segments a warp {32 // lanes} (longest first), "
            f"cast: a separate .to(torch.bfloat16) pass before the kernel")


def default_phase(op_bsr: BSR, x_op, op_csr: CSR, ddi_adj: CSR, graphs: dict,
                  best: str, read) -> dict:
    """Phase 8d: precision="default", the TPU's one bf16 pass, on its
    kernels: bf16 K1 (sdb_bsr_spmm_flat_bf16) and K5
    (sdb_bsr_spmm_resident_bf16) at bench.py's op shape, K1 at b = 32 on
    the reorder phase's arxiv graph (gorder), and K10's one-bf16-pass
    kernel (sdb_csr_spmm_bf16) at the op csr shape, at ddi (F = 256), on
    the serve phase's graph and on the reorder phase's arxiv graph under
    each of REORDER_ORDERINGS (F = 128), each with its geometry
    (k10_default_geometry). Each plan on seeded normal X: its
    kernel launched (its own entry), within KERNEL_TOL of its plain
    version and BF16_TOL of float64 (BSR: bsr_f64, or float64 scipy on
    the graph; K10: the f32 plan's plain version, float64 sums of the
    unrounded values); the counts read as "default". Then, after the
    read, where nothing rounds: bf16_exact_case at each BSR plan's b and
    F (K1 and, at b = 128, K5) and each K10 graph with integer values
    and operand, each equal to float64 bit for bit (K10: its plain
    version, float64 sums). Returns the cases for default_timing."""
    t0 = time.perf_counter()
    bsr32 = csr_to_bsr(graphs[best], 32)
    serve_adj = sym_norm_adjacency(graphs[best])
    log(f"[default] precision='default' (one bf16 pass): K1 and K5 at the op shape, "
        f"K1 b=32 on ogbn-arxiv {best} (nnzb={bsr32.nnzb}), K10 at the op csr "
        f"shape, ddi, the serve graph and ogbn-arxiv under each ordering "
        f"({time.perf_counter() - t0:.1f} s host)")
    cases = []
    for label, bsr, kw, x, kind in (
            ("op", op_bsr, {}, x_op, "flat"),
            ("op", op_bsr, {"resident": True}, x_op, "resident"),
            (f"b=32 ogbn-arxiv {best}", bsr32, {},
             torch.as_tensor(seeded((bsr32.shape[1], REORDER_F), SEED + 301),
                             device=DEV), "flat")):
        t1 = time.perf_counter()
        plan = bsr_spmm_pallas_plan(bsr, precision="default", grad=False, device=DEV,
                                    **kw)
        plan_s = time.perf_counter() - t1
        if plan.statics[0] != kind or plan.statics[5] != "bf16":
            raise AssertionError(f"default {label}: {plan.statics[0]} "
                                 f"{plan.statics[5]}, expected {kind} bf16")
        kid, name = kernel_of(plan)[:2]
        tag = f"default {kid} {label}"
        err = check_kernel(plan, x, tag)
        if bsr is op_bsr:
            want = bsr_f64(bsr, x)
        else:
            want = torch.as_tensor(graphs[best].to_scipy().astype(np.float64)
                                   @ x.double().cpu().numpy(), device=DEV)
        rel = rel_to(plan(x).double(), want)
        log(f"  {tag} vs float64: max |err| / max |ref| {rel:.3e} (< {BF16_TOL}); "
            f"plan {plan_s:.1f} s (host)")
        if not rel < BF16_TOL:
            raise AssertionError(f"{tag}: rel err {rel:.3e} vs float64")
        cases.append({"label": f"{kid} {name} precision=default {label}", "plan": plan,
                      "bsr": bsr, "x": x, "err": err, "name": name, "where": label})
    k10_cases = [("op csr", op_csr, x_op.shape[1]), ("ddi", ddi_adj, 256),
                 (f"serve {best}", serve_adj, REORDER_F)]
    k10_cases += [(f"arxiv {name}", graphs[name], REORDER_F) for name in REORDER_ORDERINGS]
    for label, csr, F in k10_cases:
        x = x_op if csr is op_csr else torch.as_tensor(
            seeded((csr.n_cols, F), SEED + 302), device=DEV)
        plan = csr_spmm_pallas_plan(csr, precision="default", grad=False, device=DEV)
        f32 = csr_spmm_pallas_plan(csr, grad=False, device=DEV)
        kid, name = kernel_of(plan)[:2]
        tag = f"default {kid} {label}"
        err = check_kernel(plan, x, tag)
        rel = rel_to(plan(x), plain_apply(f32, x))
        log(f"  {tag} vs float64 (the f32 plan's plain version): max |err| / max "
            f"|ref| {rel:.3e} (< {BF16_TOL}); {k10_default_geometry(x.shape)}")
        if not rel < BF16_TOL:
            raise AssertionError(f"{tag}: rel err {rel:.3e} vs float64")
        del f32
        cases.append({"label": f"{kid} {name} precision=default {label}", "plan": plan,
                      "csr": csr, "x": x, "err": err, "name": name, "where": label})
    expect = {}
    for c in cases:
        expect[c["name"]] = expect.get(c["name"], 0) + 2
    read("default", expect)
    for c in cases:
        c["launches"] = 2

    # where nothing rounds: every value an integer of magnitude <= 16
    for b, F in ((op_bsr.b, x_op.shape[1]), (32, REORDER_F)):
        ebsr, ex, want = bf16_exact_case(b, F)
        ex = torch.as_tensor(ex, device=DEV)
        want = torch.as_tensor(want, device=DEV).float()
        for kw in ({}, {"resident": True}) if b == op_bsr.b else ({},):
            plan = bsr_spmm_pallas_plan(ebsr, precision="default", grad=False,
                                        device=DEV, **kw)
            exact_launch(plan, ex, want, f"default {kernel_of(plan)[0]} b={b} F={F}")
    for c in (c for c in cases if "csr" in c):
        ic = int_csr(c["csr"], SEED + 303)
        xi = torch.as_tensor(np.random.default_rng(SEED + 304).integers(
            -16, 17, size=tuple(c["x"].shape)).astype(np.float32), device=DEV)
        plan = csr_spmm_pallas_plan(ic, precision="default", grad=False, device=DEV)
        got = plan(xi)
        want = plain_apply(plan, xi)  # float64 sums: exact on integers
        torch.cuda.synchronize()
        n_bad = int((got != want).sum())
        log(f"  default K10 {c['where']} integer values and operand: "
            f"{n_bad} of {got.numel()} entries differ from float64 (bit for bit)")
        if n_bad:
            raise AssertionError(f"default K10 {c['label']}: {n_bad} entries differ")
        del plan
    return {"cases": cases}


def default_timing(dp: dict, card_line: str) -> list:
    """Phase 8d's times, after the counts were read: each plan's whole
    call from the f32 operand (the cast included) by cuda_ms, its plain
    version, its bound and the library call (BSR: bf16 sparse_bsr @ X;
    K10: sparse_csr @ X in bf16 where PyTorch runs it on the card, else in
    f32). Returns the kernels line's rows."""
    rows = []
    for c in dp["cases"]:
        plan, x = c["plan"], c["x"]
        kid, name, source, replaces = kernel_of(plan)
        F = x.shape[1]
        k_ms = cuda_ms(lambda: plan(x), iters=30)
        p_ms = cuda_ms(lambda: plain_apply(plan, x), iters=2, warmup=1)
        got = plan(x)
        if "bsr" in c:
            bsr = c["bsr"]
            b_ms, b_by = bsr_bound("bf16", bsr, F)
            pad = torch.nn.functional.pad
            lib = library_ms(
                "bsr", bsr, pad(x.to(torch.bfloat16),
                                (0, 0, 0, bsr.n_block_cols * bsr.b - x.shape[0])),
                pad(got, (0, 0, 0, bsr.n_block_rows * bsr.b - bsr.shape[0])), 2,
                f"{c['label']} torch.sparse_bsr_tensor @ X, bf16")
            lib_dtype = "bf16"
            flops = 2.0 * bsr.nnzb * bsr.b * bsr.b * F
        else:
            csr = c["csr"]
            b_ms, b_by = csr_bound(csr, F, e=2)
            lib_dtype = "bf16"
            lib = library_ms("csr", csr, x.to(torch.bfloat16), got, 5,
                             f"{c['label']} torch.sparse_csr_tensor @ X, bf16")
            if lib is None:
                lib_dtype = "f32"
                lib = library_ms("csr", csr, x, got, 5,
                                 f"{c['label']} torch.sparse_csr_tensor @ X, f32")
            flops = 2.0 * csr.nnz * F
        log(f"  {c['label']}: whole call from the f32 operand {k_ms:.4f} ms "
            f"{flops / k_ms / 1e6:.1f} GFLOP/s, plain {p_ms:.3f} ms, bound {b_ms:.4f} "
            f"ms ({b_by}), library ({lib_dtype}) "
            f"{'none' if lib is None else f'{lib:.4f} ms'} [{card_line}]")
        if c["where"].startswith("serve"):  # a faster kernel may show the host
            busy, by_kernel = device_profile(lambda: plan(x), iters=20)
            if busy is None:
                log(f"  {c['label']}: device busy share not measured ({by_kernel})")
            else:
                log(f"  {c['label']}: device busy {100 * busy:.1f}% of the span; "
                    "device ms a call by kernel " + ", ".join(
                        f"{k[:60]} {v:.4f}" for k, v in list(by_kernel.items())[:4]))
        rows.append({"name": c["label"], "route": "cuda", "source": source,
                     "replaces": replaces, "launches": c["launches"],
                     "max_abs_err": c["err"], "ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                     "library_dtype": lib_dtype if lib is not None else None})
        del got
    return rows


def main_path(ddi, adj, dims, op_bsr, op_csr, x_op, calibration, card_line: str):
    """Phases 4 to 8c, each run with the launch counts set to 0 just
    before it and read just after. Returns what the timing needs."""
    totals = {}

    def read(run: str, expect: dict) -> None:
        counts = {k: v for k, v in launches().items() if v}
        log(f"[main path] {run}: launches {counts}")
        for name, n in expect.items():
            if counts.get(name, 0) != n:
                raise AssertionError(f"{run}: {name} launched {counts.get(name, 0)} "
                                     f"times, expected {n}")
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n

    n_spmm = 4 * (len(dims) - 1)
    t_phase = time.perf_counter()
    reset_launches()
    plan, model, xs, refs = slice_phase(adj, dims, n_requests=4)
    read("f32 slice", {"bsr_spmm_sorted": n_spmm})
    reset_launches()
    plan_i8, slice_i8_err = int8_slice_phase(adj, model, xs, refs)
    read("int8 slice", {"bsr_spmm_int8_sorted": n_spmm, "quantize_int8": n_spmm})
    reset_launches()
    plan_csr = csr_slice_phase(adj, model, xs, refs)
    read("csr slice", {"csr_spmm": n_spmm})
    reset_launches()
    plan_bf16, slice_bf16_err = bf16_slice_phase(adj, model, xs, refs)
    read("bf16 slice", {"bsr_spmm_sorted_bf16": n_spmm})
    t_phase = phase_done("4 slice", t_phase)

    # step 0's hidden-layer forward for the ReLU pattern (1 SpMM), 5 steps
    # of 2 forward + 1 backward SpMMs, then the eval's 2 forwards
    train = {}
    for key, precision, impl, name in (
            ("f32", None, "bsr_pallas", "bsr_spmm_sorted"),
            ("high", "high", "bsr_pallas", "bsr_spmm_sorted_bf16x3"),
            ("csr", None, "csr_pallas", "csr_spmm")):
        reset_launches()
        train[key] = train_phase(adj, dims, precision, impl)
        expect = {name: 1 + 5 * 3 + 2}
        if key == "high":  # each K3 call splits its operand once
            expect["split_bf16"] = expect[name]
        read(f"train {key}", expect)
    t_phase = phase_done("5 train", t_phase)

    reset_launches()
    plans, errs = op_phase(op_bsr, x_op, calibration)
    plans[("csr", "csr")], errs[("csr", "csr")] = csr_op_phase(op_csr, x_op)
    read("op", {})
    t_phase = phase_done("6 op", t_phase)
    # each plan's answer checked twice: against its plain version and
    # against spmm_scipy
    reset_launches()
    t0 = time.perf_counter()
    rphase = reorder_phase(ROOT / "build" / "datasets")
    log(f"[reorder] phase in {time.perf_counter() - t0:.1f} s")
    expect = {"csr_spmm": 2 * len(REORDER_ORDERINGS)}
    for _, _, kw, name in REORDER_BSR:
        expect[name] = expect.get(name, 0) + 2
        if kw.get("precision") == "high":  # each K3 call splits its operand
            expect["split_bf16"] = expect.get("split_bf16", 0) + 2
        if kw.get("dtype") is torch.int8:  # each int8 call quantizes its operand
            expect["quantize_int8"] = expect.get("quantize_int8", 0) + 2
    read("reorder", expect)
    t0 = time.perf_counter()
    reorder_normal_check(rphase)
    # its times now, after the counts were read; each BSR plan's gigabytes
    # on the card go back after its timing, the rest before the other
    # phases are timed
    reorder_rows = reorder_timing(rphase, card_line)
    log(f"[reorder] checks on normal X and timing in {time.perf_counter() - t0:.1f} s")
    graphs = {name: run["csr"] for name, run in rphase["runs"].items()}
    best = rphase["best"]
    del rphase
    torch.cuda.empty_cache()
    t_phase = phase_done("7 reorder (with its timing)", t_phase)
    reset_launches()
    t0 = time.perf_counter()
    sp = serve_phase(graphs, best)
    log(f"[serve] phase in {time.perf_counter() - t0:.1f} s")
    read("serve", sp["expect"])
    sp["launched"] = launches()
    t_phase = phase_done("8 serve", t_phase)
    t0 = time.perf_counter()
    mp = models_phase(ddi, graphs, best, op_bsr, plans[("f32", "sorted")], x_op, read)
    log(f"[models] phase in {time.perf_counter() - t0:.1f} s")
    t_phase = phase_done("8b models", t_phase)
    reset_launches()
    t0 = time.perf_counter()
    bench_phase(op_bsr, plans[("f32", "sorted")], x_op, graphs, card_line)
    log(f"[bench] phase in {time.perf_counter() - t0:.1f} s")
    read("bench", {})
    silent = [name for name in BENCH_KERNELS if launches()[name] == 0]
    if silent:
        raise AssertionError(f"bench: not launched: {silent}")
    t_phase = phase_done("8c bench", t_phase)
    torch.cuda.empty_cache()
    reset_launches()
    dp = default_phase(op_bsr, x_op, op_csr, adj, graphs, best, read)
    t_phase = phase_done("8d default", t_phase)
    missing = [name for name in [kernel_of(p)[1] for p in plans.values()]
               + ["split_bf16", "quantize_int8", "ell_spmm"] if totals.get(name, 0) == 0]
    if missing:
        raise AssertionError(f"not launched on the main path: {missing}")
    # the operand kernels called directly against their plain versions,
    # after the counts were read: these launches do not count
    i8 = plans[("int8", "sorted")]
    errs[("split", "split")] = check_split(x_op)
    # at the op shape (no pad rows), there with a NaN, a +Inf and a -Inf
    # column (0, +-127 or, in a dynamic column of scale Inf, 0), and at the
    # int8 slice's (dynamic scales, ddi's rows padded to the block grid)
    x_nf = x_op.clone()
    x_nf[5, 0], x_nf[6, 1], x_nf[7, 2] = float("nan"), float("inf"), float("-inf")
    errs[("quantize", "quantize")] = max(
        check_quantize(x_op, i8.statics[4], i8.arrays[-1], "op"),
        check_quantize(x_nf, i8.statics[4], i8.arrays[-1], "op, NaN and +-Inf"),
        check_quantize(xs[0], plan_i8.statics[4], None, "ddi"))
    q_dyn = quantize_int8(x_nf, i8.statics[4])[0]
    q_st = quantize_int8(x_nf, i8.statics[4], i8.arrays[-1])[0]
    if (q_dyn[5, 0] != 0 or q_dyn[:, 1:3].any() or q_st[5, 0] != 0
            or q_st[6, 1] != 127 or q_st[7, 2] != -127):
        raise AssertionError("quantize_int8: NaN or +-Inf not as JAX quantizes it")
    slices = {"f32": plan, "int8": plan_i8, "csr": plan_csr, "bf16": plan_bf16}
    return (slices, model, xs, train, plans, errs, totals,
            {"int8": slice_i8_err, "bf16": slice_bf16_err}, reorder_rows, sp, mp,
            dp, graphs)


def bound(tag: str, flops: float, nbytes: float) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over the device
    memory rate and the operations over the peak of their type."""
    t_ops = flops / PEAK_OPS_S[tag]
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def bsr_bound(tag: str, bsr: BSR, F: int) -> tuple:
    """A BSR kernel's bound on these inputs: the real blocks only (no pad
    slots) and their column ids, the operand and the f32 output, each
    once; 2 b^2 F operations per real block (three products for "high")."""
    e = ELEM_BYTES[tag]
    b, (M, K) = bsr.b, bsr.shape
    nbytes = bsr.nnzb * (b * b * e + 4) + K * F * e + M * F * 4
    flops = 2.0 * bsr.nnzb * b * b * F * (3 if tag == "high" else 1)
    return bound(tag, flops, nbytes)


def csr_bound(csr: CSR, F: int, e: int = 4) -> tuple:
    """K10's bound: the real nonzeros (int32 col and an e-byte val) and a
    row pointer, the e-byte operand and the f32 output, each once; 2 F
    operations per nonzero at the card's peak for the operands' type
    (e = 4: f32 on FFMA; e = 2, the one-bf16-pass instance: bf16 products
    with f32 sums, the bf16 tensor cores' peak)."""
    M, K = csr.shape
    nbytes = csr.nnz * (4 + e) + (M + 1) * 8 + K * F * e + M * F * 4
    return bound("bf16" if e == 2 else "f32", 2.0 * csr.nnz * F, nbytes)


def reorder_timing(rp: dict, card_line: str) -> list:
    """The reorder phase's times: K10 on each ordering, then each of
    REORDER_BSR's plans on the ordering with the fewest blocks (f32 K2 at
    b = 32, whose time makes the CSR/BSR ratio, f32 K2 at 16, K1 at 32,
    bf16 K2 and K3 sorted at 32 and 16, int8 K7 at 32 and 16), each
    beside its plain version,
    its bound and the PyTorch library call, its slots, its deepest lane's
    slots and its F tile width (bsr_row); then, once, REORDER_ONCE's plans
    at REORDER_B, each checked against its plain version first. Each BSR
    plan is freed after its timing. GFLOP/s = 2 nnz F / t (CSR) or 2 nnzb
    b^2 F / t (real blocks). Returns the kernels line's rows of
    REORDER_BSR's instances (their launches on the path: each plan's
    check against its plain version and against spmm_scipy)."""
    x, F = rp["x"], REORDER_F
    csr_ms = {}
    for name, run in rp["runs"].items():
        rcsr, plan = run["csr"], run["plan"]
        k_ms = cuda_ms(lambda: plan(x), iters=20)
        p_ms = cuda_ms(lambda: plain_apply(plan, x), iters=3, warmup=1)
        lib = library_ms("csr", rcsr, x, plan(x), 10,
                         f"reorder {name} torch.sparse_csr_tensor @ X, F={F}")
        b_ms, b_by = csr_bound(rcsr, F)
        flops = 2.0 * rcsr.nnz * F
        csr_ms[name] = k_ms
        log(f"  reorder {name:<8} K10 csr_spmm kernel {k_ms:.4f} ms "
            f"{flops / k_ms / 1e6:.1f} GFLOP/s, plain {p_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}; b=32 nnzb "
            f"{int(run['metrics'][32]['nnzb'])}, ordering {run['host_s']:.3f} s "
            f"[{card_line}]")
    best = rp["best"]
    bsr32, k2_ms, rows, lib_cache = rp["bsr_runs"][0]["bsr"], None, [], {}
    while rp["bsr_runs"]:
        br = rp["bsr_runs"].pop(0)
        bsr, plan = br["bsr"], br.pop("plan")
        row = bsr_row(f"reorder {best:<8} {br['kid']}", bsr, plan, x, br["plan_s"],
                      card_line, lib_cache)
        kid, name, source, replaces = kernel_of(plan)
        rows.append({"name": f"{kid} {name} b={bsr.b} {REORDER_DATASET} {best}",
                     "route": "cuda", "source": source, "replaces": replaces,
                     "launches": br["launches"], "max_abs_err": br["err"], **row})
        if k2_ms is None:
            k2_ms = row["ms"]
            log(f"  reorder {best}: CSR / BSR = {csr_ms[best] / k2_ms:.3f} (K10 "
                f"{csr_ms[best]:.4f} ms, K2 b={bsr.b} {k2_ms:.4f} ms) [{card_line}]")
        del plan
        torch.cuda.empty_cache()
    # once, after the path: the walks beside the targets
    for label, kw, name in REORDER_ONCE:
        t0 = time.perf_counter()
        plan = spmm_plan(bsr32, impl="bsr_pallas", block_size=bsr32.b, grad=False,
                         device=DEV, **kw)
        plan_s = time.perf_counter() - t0
        if kernel_of(plan)[1] != name:
            raise AssertionError(f"reorder {label}: {kernel_of(plan)[1]}, expected {name}")
        check_kernel(plan, x, f"reorder {best} {label} b={bsr32.b} F={F}")
        bsr_row(f"reorder {best:<8} {label}", bsr32, plan, x, plan_s, card_line,
                lib_cache)
        del plan
        torch.cuda.empty_cache()
    lib_cache.clear()
    torch.cuda.empty_cache()
    return rows


def bsr_row(label: str, bsr: BSR, plan, x, plan_s: float, card_line: str,
            lib_cache: dict) -> dict:
    """One BSR plan's times, logged: the kernel (bf16 plans on the
    bf16 operand, as the library call gets it; K3 with its operand split;
    int8 on an operand quantized beforehand, the whole call beside it),
    its plain version, its bound, the PyTorch library call (none for
    int8), its slots, its deepest lane and its F tile width. lib_cache
    keeps the library call's sparse tensors from row to row. Returns the
    kernels line's timing keys."""
    F, tag, name = x.shape[1], plan_tag(plan), kernel_of(plan)[1]
    if tag == "int8":  # the kernel alone on an operand quantized beforehand
        qt, cs = quantize_operand(plan, x, transposed=True)
        kernel = lambda: run_quantized(plan, None, cs, qdense_t=qt)  # noqa: E731
        plain = lambda: run_quantized(plan, None, cs, plain=True,  # noqa: E731
                                      qdense_t=qt)
        lib = None
        bn = int8_bn(plan, F)
        extra = (f", deepest lane {plan.statics[6]} slots, whole call with "
                 f"dynamic quantization {cuda_ms(lambda: plan(x), iters=5):.4f} ms")
    else:
        pad = torch.nn.functional.pad
        xk = x.to(torch.bfloat16) if tag == "bf16" else x
        kernel = lambda: plan(xk)  # noqa: E731
        plain = lambda: plain_apply(plan, xk)  # noqa: E731
        # the library call multiplies the whole block grid: pad X and the
        # answer to it
        lib = library_ms(
            "bsr", bsr, pad(xk, (0, 0, 0, bsr.n_block_cols * bsr.b - x.shape[0])),
            pad(plan(xk), (0, 0, 0, bsr.n_block_rows * bsr.b - bsr.shape[0])), 2,
            f"{label} torch.sparse_bsr_tensor @ X, {tag}, b={bsr.b}, F={F}",
            lib_cache)
        geometry = f32_small_geometry if tag == "f32" else bf16_small_geometry
        bn = tile_bn(name, bsr, F) or geometry(bsr.b, F, _sm_count(0),
                                               plan_slots(plan), plan.statics[6])[0]
        extra = f", deepest lane {plan.statics[6]} slots"
    k_ms = cuda_ms(kernel, iters=10)
    p_ms = cuda_ms(plain, iters=2, warmup=1)
    b_ms, b_by = bsr_bound(tag, bsr, F)
    flops = 2.0 * bsr.nnzb * bsr.b * bsr.b * F
    log(f"  {label} {name} b={bsr.b} kernel {k_ms:.4f} ms "
        f"{flops / k_ms / 1e6:.1f} GFLOP/s on real blocks, plain {p_ms:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), library "
        f"{'none' if lib is None else f'{lib:.4f} ms'}, {plan_slots(plan)} slots"
        f"{extra}, BN={bn}, plan {plan_s:.1f} s (host) [{card_line}]")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib, "bn": bn, "slots": plan_slots(plan)}


def device_profile(fn, iters: int):
    """fn's device work under torch.profiler over `iters` calls: (the
    card's busy share of the span from the first kernel's start to the
    last one's end, {kernel name: device ms per call}, largest first), or
    (None, why) where the profiler gives no device time. The ranges that
    _kernels' launchers open under the profiler (sdb_<entry>) show on the
    device's timeline too, over their kernels: they are not device work
    and are left out, or a kernel would count twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ranges = {k.symbol for k in _kernels.KERNELS}
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and e.name not in ranges]
    except Exception as e:  # a measurement only: record why there is none
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    if not device:
        return None, "the profiler saw no device time"
    span = (max(e.time_range.end for e in device)
            - min(e.time_range.start for e in device))
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values()) / span
    return busy, {k: v / iters / 1e3
                  for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])}


def library_call(kind: str, mat, x, cache: dict = None):
    """One PyTorch call computing what a kernel computes, as a yardstick
    (the port never calls it): torch.sparse_bsr_tensor @ X of the real
    blocks ("bsr", in x's dtype) or torch.sparse_csr_tensor @ X ("csr", its
    values in x's dtype).
    Returns (fn, None), or (None, the error) where PyTorch refuses the
    call on the card. `cache` keeps each matrix's sparse tensor for the
    next call on the same matrix and dtype."""
    key = (kind, id(mat), x.dtype)
    try:
        if cache is not None and key in cache:
            a = cache[key]
        elif kind == "csr":
            a = torch.sparse_csr_tensor(
                torch.as_tensor(mat.indptr.astype(np.int64), device=DEV),
                torch.as_tensor(mat.indices.astype(np.int64), device=DEV),
                torch.as_tensor(mat.values(), device=DEV).to(x.dtype), mat.shape,
                check_invariants=False)
        else:
            n = mat.nnzb
            rows, cols = mat.block_rows[:n], mat.block_cols[:n]
            order = np.lexsort((cols, rows))
            crow = np.searchsorted(rows[order], np.arange(mat.n_block_rows + 1))
            a = torch.sparse_bsr_tensor(
                torch.as_tensor(crow.astype(np.int64), device=DEV),
                torch.as_tensor(cols[order].astype(np.int64), device=DEV),
                torch.as_tensor(mat.blocks[:n][order], device=DEV).to(x.dtype),
                (mat.n_block_rows * mat.b, mat.n_block_cols * mat.b),
                check_invariants=False)
        if cache is not None:
            cache[key] = a
        fn = lambda: a @ x  # noqa: E731
        fn()
        torch.cuda.synchronize()
        return fn, None
    except Exception as e:  # the yardstick only: record PyTorch's refusal
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def library_ms(kind: str, mat, x, want, iters: int, label: str,
               cache: dict = None):
    """Times library_call; logs its error against the kernel's answer
    `want`, or PyTorch's refusal. Returns ms or None."""
    with warnings.catch_warnings():  # "sparse ... support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        fn, err = library_call(kind, mat, x, cache)
    if fn is None:
        log(f"  library {label}: none ({err})")
        return None
    rel = rel_to(fn().float(), want)
    ms = cuda_ms(fn, iters=iters)
    log(f"  library {label}: {ms:.3f} ms, max |err| / max |kernel| {rel:.3e}")
    return ms


# ---- phase 10: the distributed layer (parallel/) ------------------------------

DIST_RANKS = 4
DIST_OP = (2e-2, 1024, 128, 512)  # bench.py's op shape: p, block-rows, b, F
DIST_TIMED = 2              # calls timed per run and rank
DIST_QUICK = (2e-4, 64)     # the quick bsrmm grid's matrix (b = 128): p, F
DIST_BAND = (1024, 32, 64)  # (c)'s banded matrices: block-rows, b, F
DIST_LPT_B = 32             # (c)'s LPT run: arxiv under gorder at this b
DIST_TOL = {"f32": CHECK_EPS, "high": CHECK_EPS, "bf16": BF16_TOL, "int8": INT8_TOL}
DIST_OP_RUNS = tuple(
    (f"op {s} {tag}", s, tag, kw)
    for s in ("allgather", "ring")
    for tag, kw in (("f32", {}), ("bf16", {"dtype": torch.bfloat16}),
                    ("high", {"precision": "high"}),
                    ("int8", {"dtype": torch.int8, "calibrated": True}),
                    ("int8", {"dtype": torch.int8})))


def _sync() -> None:
    if DEV == "cuda":
        torch.cuda.synchronize()


def dist_kernel(tag, dtype: str, precision) -> str:
    """The counter of the kernel a distributed BSR plan's stripes launch,
    from its layout tag (parallel.spmm.layout_tag)."""
    if dtype == "int8":
        return ("bsr_spmm_int8_sorted" if isinstance(tag, tuple)
                else "bsr_spmm_int8_rowgroup" if tag else "bsr_spmm_int8_flat")
    suffix = ("_bf16x3" if precision == "high" and dtype == "f32"
              else "_bf16" if dtype == "bf16" else "")
    if isinstance(tag, tuple):
        return "bsr_spmm_sorted" + suffix
    if tag:
        return "bsr_spmm_rowgroup" + suffix
    if dtype == "bf16" and precision is None:
        return "bsr_spmm_resident_bf16"  # the router's 2-byte branch: K5
    return "bsr_spmm_flat" + suffix


def dist_expect(plan, dtype: str, precision) -> dict:
    """Launches per rank and call: one kernel a router call (allgather 1,
    ring n, halo 2*halo+1), one operand split a K3 call, one quantize_int8
    a call for int8; none for the xla local impl."""
    while plan.subplans is not None:  # the LPT wrapper
        plan = plan.subplans[0]
    info, strategy, st = plan.statics
    if st["local_impl"] != "pallas":
        return {}
    calls = len(st["buckets"])
    name = dist_kernel(layout_tag(plan), dtype, precision)
    out = {name: calls}
    if name.endswith("_bf16x3"):
        out["split_bf16"] = calls
    if dtype == "int8":
        out["quantize_int8"] = 1
    return out


def dist_measure(label: str, plan, plan_s: float, call, expect: dict,
                 strategy: str = "allgather", op: str = "all_gather"):
    """One run of a rank: call() once with the counts set to 0 just
    before it and read just after (on the card each kernel of expect
    launched its count and no other launched), then DIST_TIMED calls
    timed by the host clock with the card synchronized, every rank
    starting together. op is the collective the plan's exchange runs.
    Returns call()'s first answer and the run's record."""
    import torch.distributed as dist

    from spmm_denseblock_tpu_torch.parallel import exchange as exch

    info = exch.dist_info(plan)
    reset_launches()
    exch.reset_counts()
    with torch.no_grad():
        got = call()
    _sync()
    counts = {k: v for k, v in launches().items() if v}
    moved, trips = exch.COUNTS["bytes_received"], exch.COUNTS["host_round_trips"]
    if DEV == "cuda" and counts != expect:
        raise AssertionError(f"{label}: launches {counts}, expected {expect}")
    dist.barrier()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(DIST_TIMED):
            call()
    _sync()
    ms = (time.perf_counter() - t0) * 1e3 / DIST_TIMED
    return got, {"name": label, "strategy": strategy,
                 "transport": exch.transport(info.group, info.device, op),
                 "plan_s": plan_s, "ms": ms, "launches": counts,
                 "bytes_received": moved, "host_round_trips": trips,
                 "model_bytes": None}


def dist_run(label: str, build, x, expect, ref=None, gate=None, F=None,
             itemsize=4, keep: bool = False):
    """One run of a distributed BSR plan on a rank: the plan built
    (seconds), measured by dist_measure (expect is a dict or a function
    of the plan), the stripe against its routers' plain versions
    (KERNEL_TOL), the gathered C against ref() on rank 0 (gate, relative
    to max |ref|), and the exchange's bytes beside comms_bytes_per_device.
    Returns the run's record (and the plan with keep)."""
    import torch.distributed as dist

    from spmm_denseblock_tpu_torch.ops.plan import run
    from spmm_denseblock_tpu_torch.parallel import exchange as exch
    from spmm_denseblock_tpu_torch.parallel.comms import comms_bytes_per_device

    t0 = time.perf_counter()
    plan = build()
    _sync()
    plan_s = time.perf_counter() - t0
    if callable(expect):
        expect = expect(plan)
    info = exch.dist_info(plan)
    strategy = strategy_of(plan)
    kind = strategy.split()[-1]
    c, rec = dist_measure(label, plan, plan_s, lambda: plan(x), expect, strategy,
                          "send_recv" if kind in ("ring", "halo") else "all_gather")
    if c.device.type != DEV or not torch.isfinite(c).all():
        raise AssertionError(f"{label}: the stripe is not finite on {DEV}")
    plain = run(plan, x, plain=True)
    err = (c - plain).abs().max().item() if c.numel() else 0.0
    krel = rel_err(c, plain) if c.numel() else 0.0
    if krel >= KERNEL_TOL:
        raise AssertionError(f"{label}: stripe vs plain rel {krel:.3e} >= {KERNEL_TOL}")
    del plain
    full = exch.gather_output(plan, c)
    rel = None
    if ref is not None and dist.get_rank() == 0:
        want = torch.as_tensor(ref(), device=full.device)
        got = full[: want.shape[0]]
        rel = (got.double() - want.double()).abs().max().item() / max(
            want.abs().max().item(), 1e-30)
        if not rel < gate:
            raise AssertionError(f"{label}: gathered C vs reference rel {rel:.3e} "
                                 f">= {gate}")
    del full, c
    K = info.split.chunk * info.n
    Fs = info.feature_slice(F if F is not None else x.shape[1])[0]
    rec.update(model_bytes=comms_bytes_per_device(kind, info.n, K, Fs, itemsize),
               max_abs_err=err, rel_plain=krel, rel_ref=rel)
    return (rec, plan) if keep else rec


def bsr_scipy(bsr: BSR, x: np.ndarray) -> np.ndarray:
    """spmm_scipy of a BSR through its CSR form (bsr_to_csr): the sparse
    product, where spmm_scipy would densify the BSR (68 GB at 1,024
    block-rows of 128)."""
    return spmm_scipy(bsr_to_csr(bsr), x)


def _first_rows_ref(bsr: BSR, x: np.ndarray, nb: int):
    """bsr_scipy on the first nb block-rows of bsr."""
    def ref():
        keep = bsr.block_rows[:bsr.nnzb] < nb
        sub = BSR.from_parts(bsr.block_rows[:bsr.nnzb][keep],
                             bsr.block_cols[:bsr.nnzb][keep],
                             bsr.blocks[:bsr.nnzb][keep],
                             (min(nb * bsr.b, bsr.shape[0]), bsr.shape[1]), bsr.b)
        return bsr_scipy(sub, x)
    return ref


def banded_bsr(n_br: int, b: int, widths, seed: int) -> BSR:
    """A banded BSR of n_br block-rows: block-row i holds the blocks of
    columns i-w .. i+w (clipped), w = widths[i * len(widths) // n_br], so
    the loads fall from the first stripe to the last when widths do."""
    rows, cols = [], []
    for i in range(n_br):
        w = widths[i * len(widths) // n_br]
        c = np.arange(max(0, i - w), min(n_br, i + w + 1))
        rows.append(np.full(c.size, i))
        cols.append(c)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    blocks = np.random.default_rng(seed).standard_normal(
        (rows.size, b, b)).astype(np.float32)
    return BSR.from_parts(rows.astype(np.int32), cols.astype(np.int32), blocks,
                          (n_br * b, n_br * b), b)


def _gcn_dist(plan, params, x, chain: bool):
    """The GCN request across the ranks: with chain, each rank feeds its
    output stripe to the next layer (rows move only in the plan's
    exchange) and the logits are gathered once at the end; else every
    layer's C is gathered."""
    from spmm_denseblock_tpu_torch.parallel.exchange import (
        RowStripe,
        gather_output,
        operand_rows,
    )

    if chain:
        lo, hi = operand_rows(plan)
        out = gcn_apply(params, lambda h: plan(RowStripe(h)), x[lo:hi])
        return gather_output(plan, out)
    return gcn_apply(params, lambda h: gather_output(plan, plan(h)), x)


def _chainable(plan) -> bool:
    from spmm_denseblock_tpu_torch.parallel.exchange import dist_info

    info = dist_info(plan)
    return all(np.array_equal(r, np.arange(lo, hi))
               for r, lo, hi in zip(info.out_rows, info.split.lo, info.split.hi))


def dist_rank(rank: int, n: int, cfg: dict) -> dict:
    """Phase 10 (b)-(f) on one of the world's ranks, all sharing the one
    GPU over gloo. Returns its runs' records and, on rank 0, the gathered
    answers the parent holds to the single-card ones."""
    from spmm_denseblock_tpu_torch.parallel import (
        dist_bsr_spmm_plan,
        dist_csr_spmm_plan,
        dist_hybrid_spmm_plan,
        dist_sddmm_plan,
        dist_windowed_spmm_plan,
        make_mesh,
        make_mesh_1d,
    )
    from spmm_denseblock_tpu_torch.parallel import exchange as exch
    from spmm_denseblock_tpu_torch.parallel.spmm import gather_edges

    global DEV
    DEV = dev = cfg["device"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    out = {"runs": [], "answers": {}, "auto": {}, "sections": {}}
    t_sec = [time.perf_counter()]

    def section(name: str) -> None:  # a section's seconds on this rank
        now = time.perf_counter()
        out["sections"][name] = now - t_sec[0]
        t_sec[0] = now
    if dev == "cuda":
        _kernels.load()  # built by the parent
    mesh = make_mesh_1d(n, device_type=dev)
    mesh2 = make_mesh((2, n // 2), device_type=dev)
    p, nbr, b, F = cfg["op"]
    op = random_bsr(p, nbr, block_size=b, seed=SEED)
    x_np = seeded((op.shape[1], F), SEED)
    x = torch.as_tensor(x_np, device=dev)
    cal = x_np[:4096]
    ref = _first_rows_ref(op, x_np, BENCH_CHECK_BLOCK_ROWS)

    def bsr_run(label, mat, xx, strategy, tag, gate=None, refn=None, mesh_=mesh, **kw):
        dtype = ("int8" if kw.get("dtype") is torch.int8 else
                 "bf16" if kw.get("dtype") is torch.bfloat16 else "f32")
        prec = kw.get("precision")
        if kw.pop("calibrated", False):
            kw["calibration"] = cal
        kw.setdefault("local_impl", "pallas")

        def build():
            return dist_bsr_spmm_plan(mat, mesh=mesh_, strategy=strategy, device=dev,
                                      **kw)

        rec = dist_run(label, build, xx, lambda p: dist_expect(p, dtype, prec), refn,
                       gate or DIST_TOL[tag],
                       itemsize={"f32": 4, "bf16": 2, "int8": 1}[dtype])
        out["runs"].append(rec)
        return rec

    # (b) the op shape over the four ranks: every dtype and both strategies
    for label, strategy, tag, kw in DIST_OP_RUNS:
        if kw.get("calibrated"):
            label += " calibrated"
        bsr_run(label, op, x, strategy, tag, refn=ref, **dict(kw))
        torch.cuda.empty_cache()
    bsr_run("op allgather f32 xla", op, x, "allgather", "f32", refn=ref,
            local_impl="xla")
    bsr_run("op allgather f32 (2, 2) mesh, feature axis", op, x, "allgather", "f32",
            refn=ref, mesh_=mesh2, feature_axis="col")
    del op
    torch.cuda.empty_cache()
    section("(b) op shape")
    qp, qF = cfg["quick"]
    quick = random_bsr(qp, nbr, block_size=b, seed=SEED)
    xq_np = seeded((quick.shape[1], qF), SEED + 1)
    xq = torch.as_tensor(xq_np, device=dev)
    for tag, kw in (("f32", {}), ("bf16", {"dtype": torch.bfloat16}),
                    ("int8", {"dtype": torch.int8})):
        bsr_run(f"quick allgather {tag} ({quick.nnzb} blocks)", quick, xq, "allgather",
                tag, refn=_first_rows_ref(quick, xq_np, nbr), **kw)
    section("(b) quick grid")
    # (c) halo and balance
    n_br, bb, bF = cfg["band"]
    band = banded_bsr(n_br, bb, (1,), SEED + 2)
    xb_np = seeded((band.shape[1], bF), SEED + 3)
    xb = torch.as_tensor(xb_np, device=dev)
    graded = banded_bsr(n_br, bb, (3, 1, 0), SEED + 4)
    for label, mat, kw in (("band halo", band, {"strategy": "halo"}),
                           ("graded band halo contiguous", graded,
                            {"strategy": "halo", "balance": "contiguous"})):
        bsr_run(label, mat, xb, kw.pop("strategy"), "f32",
                refn=lambda m=mat: bsr_scipy(m, xb_np), **kw)
        out["auto"][label] = plan_strategy(mat, n)
    arxiv = {k: CSR(*v) for k, v in cfg["arxiv"].items()}
    adj_g = sym_norm_adjacency(arxiv["gorder"])
    lpt = csr_to_bsr(adj_g, cfg["lpt_b"])
    xa_np = seeded((adj_g.n_rows, REORDER_F), SEED + 5)
    xa = torch.as_tensor(xa_np, device=dev)
    bsr_run(f"arxiv gorder b={cfg['lpt_b']} allgather balance=True", lpt, xa,
            "allgather", "f32", refn=lambda: spmm_scipy(adj_g, xa_np), balance=True)
    out["auto"]["arxiv gorder LPT"] = plan_strategy(lpt, n)
    del lpt
    torch.cuda.empty_cache()
    section("(c) halo and balance")
    # (d) the ddi GCN request, each rank's output stripe fed to the next layer
    ddi = CSR(*cfg["ddi"])
    dparams = [{k: torch.as_tensor(v, device=dev) for k, v in q.items()}
               for q in cfg["ddi_params"]]
    xd = torch.as_tensor(cfg["ddi_x"], device=dev)
    dbsr = csr_to_bsr(ddi, 128)
    for tag, kw, name in (("f32", {}, "bsr_spmm_sorted"),
                          ("int8", {"dtype": torch.int8}, "bsr_spmm_int8_sorted")):
        t0 = time.perf_counter()
        plan = dist_bsr_spmm_plan(dbsr, mesh=mesh, local_impl="pallas", balance=False,
                                  device=dev, **kw)
        plan_s = time.perf_counter() - t0
        if not _chainable(plan):
            raise AssertionError("ddi: the plan's output stripes are not its operand's")
        n_spmm = len(dparams)
        expect = {name: n_spmm, **({"quantize_int8": n_spmm} if tag == "int8" else {})}
        logits, rec = dist_measure(f"ddi GCN {tag} request", plan, plan_s,
                                   lambda: _gcn_dist(plan, dparams, xd, True), expect,
                                   strategy_of(plan))
        out["runs"].append({**rec, "tag": str(layout_tag(plan))})
        if rank == 0:
            out["answers"][f"ddi {tag}"] = logits.cpu().numpy()
        del plan
    section("(d) ddi GCN")
    # (e) the arxiv GCN request: hybrid under gorder, ELL under original
    # (torch ops: no kernel launches)
    aparams = [{k: torch.as_tensor(v, device=dev) for k, v in q.items()}
               for q in cfg["arxiv_params"]]
    xr = torch.as_tensor(cfg["arxiv_x"], device=dev)
    adj_o = sym_norm_adjacency(arxiv["original"])
    for label, build in (
            ("arxiv GCN hybrid gorder", lambda: dist_hybrid_spmm_plan(
                cfg["arxiv_hybrid"], mesh=mesh, device=dev)),
            ("arxiv GCN csr_ell original", lambda: dist_csr_spmm_plan(
                adj_o, mesh=mesh, device=dev))):
        t0 = time.perf_counter()
        plan = build()
        plan_s = time.perf_counter() - t0
        chain = _chainable(plan)
        logits, rec = dist_measure(
            label + (" (stripes chained)" if chain else " (C gathered each layer)"),
            plan, plan_s, lambda: _gcn_dist(plan, aparams, xr, chain), {})
        out["runs"].append(rec)
        if rank == 0:
            out["answers"][label] = logits.cpu().numpy()
        del plan
    section("(e) arxiv GCN")
    # (f) the windowed tier and SDDMM on arxiv (gorder), each call timed
    # without the gather of its answer
    xw = torch.as_tensor(cfg["arxiv_xw"], device=dev)
    t0 = time.perf_counter()
    wplan = dist_windowed_spmm_plan(divide_windowed(adj_g, tile_rows=256, window=1024),
                                    mesh=mesh, device=dev)
    cw, rec = dist_measure("arxiv windowed gorder", wplan, time.perf_counter() - t0,
                           lambda: wplan(xw), {})
    out["runs"].append(rec)
    with torch.no_grad():
        cw = exch.gather_output(wplan, cw)
    if rank == 0:
        out["answers"]["windowed"] = cw.cpu().numpy()
    del wplan, cw
    t0 = time.perf_counter()
    splan = dist_sddmm_plan(adj_g, mesh=mesh, device=dev)
    xs_ = torch.as_tensor(cfg["sddmm_x"], device=dev)
    e, rec = dist_measure("arxiv sddmm gorder", splan, time.perf_counter() - t0,
                          lambda: splan(xs_, xs_), {})
    out["runs"].append(rec)
    with torch.no_grad():
        e = gather_edges(splan, e)
    if rank == 0:
        out["answers"]["sddmm"] = e.cpu().numpy()
    section("(f) windowed and SDDMM")
    out["seconds"] = time.perf_counter() - t_start
    return out


def dist_nccl_one_rank(op_bsr: BSR, x_op, k2_op, card_line: str) -> list:
    """Phase 10 (a): one rank over NCCL on cuda:0, in this process, at the
    op shape: allgather and ring with f32 K2 stripes, each against its
    plain version and spmm_scipy on the first block-rows, timed beside the
    single-card K2 plan (the distributed layer's own cost)."""
    import tempfile

    import torch.distributed as dist

    from spmm_denseblock_tpu_torch.parallel import dist_bsr_spmm_plan, make_mesh_1d

    store = tempfile.mkdtemp(prefix="sdb_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            world_size=1, rank=0)
    recs = []
    try:
        mesh = make_mesh_1d(1)
        x_np = x_op.cpu().numpy()
        ref = _first_rows_ref(op_bsr, x_np, BENCH_CHECK_BLOCK_ROWS)
        for strategy in ("allgather", "ring"):
            build = functools.partial(dist_bsr_spmm_plan, op_bsr, mesh=mesh,
                                      strategy=strategy, local_impl="pallas")
            rec, plan = dist_run(f"op {strategy} f32, 1 rank over NCCL", build, x_op,
                                 {"bsr_spmm_sorted": 1}, ref, CHECK_EPS, keep=True)
            k1 = cuda_ms(lambda: k2_op(x_op), iters=10)
            d1 = cuda_ms(lambda: plan(x_op), iters=10)
            d2 = cuda_ms(lambda: plan(x_op), iters=10)
            k2 = cuda_ms(lambda: k2_op(x_op), iters=10)
            rec.update(cuda_ms=(d1 + d2) / 2, k2_ms=(k1 + k2) / 2, runs=[k1, d1, d2, k2])
            recs.append(rec)
            log(f"  dist (a) {rec['name']}: transport {rec['transport']}, plan "
                f"{rec['plan_s']:.2f} s, {rec['cuda_ms']:.3f} ms a call beside "
                f"single-card K2 {rec['k2_ms']:.3f} ms (order K2, dist, dist, K2: "
                f"{k1:.3f}, {d1:.3f}, {d2:.3f}, {k2:.3f}); the layer's own cost "
                f"{rec['cuda_ms'] - rec['k2_ms']:+.3f} ms; launches {rec['launches']}; "
                f"max |kernel - plain| {rec['max_abs_err']:.3e}; first "
                f"{BENCH_CHECK_BLOCK_ROWS} block-rows vs spmm_scipy rel "
                f"{rec['rel_ref']:.3e} [{card_line}]")
            del plan
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return recs


def dist_phase(op_bsr: BSR, x_op, k2_op, ddi_adj: CSR, ddi_model, ddi_plans: dict,
               graphs: dict, card_line: str) -> dict:
    """Phase 10: the distributed layer. (a) one NCCL rank in this process;
    (b)-(f) four gloo ranks spawned on the one GPU (parallel.world),
    every rank's runs checked in the rank (launches, stripe vs plain,
    gathered C vs spmm_scipy), the GCN, windowed and SDDMM answers here
    against the single-card ones on the same inputs. Returns the dist
    JSON line's object."""
    from spmm_denseblock_tpu_torch.ops.sddmm import sddmm
    from spmm_denseblock_tpu_torch.ops.windowed_spmm import windowed_spmm_plan
    from spmm_denseblock_tpu_torch.parallel.world import run_world

    t_phase = time.perf_counter()
    log(f"[dist] (a) one rank over NCCL [{card_line}]")
    a = dist_nccl_one_rank(op_bsr, x_op, k2_op, card_line)
    gen = torch.Generator().manual_seed(SEED + 20)
    amodel = GCN(SERVE_DIMS, generator=gen)
    arxiv_np = {k: (g.indptr, g.indices, g.data, g.shape)
                for k, g in graphs.items() if k in ("gorder", "original")}
    adj_g = sym_norm_adjacency(graphs["gorder"])
    hyb = _explicit_hybrid(adj_g, "hybrid", 128, {})
    cfg = {
        "device": DEV,
        "op": DIST_OP,
        "quick": DIST_QUICK,
        "lpt_b": DIST_LPT_B,
        "band": DIST_BAND,
        "arxiv": arxiv_np,
        "ddi": (ddi_adj.indptr, ddi_adj.indices, ddi_adj.data, ddi_adj.shape),
        "ddi_params": [{k: v.detach().cpu().numpy() for k, v in q.items()}
                       for q in ddi_model.params()],
        "ddi_x": seeded((ddi_adj.n_rows, ddi_model.dims[0]), SEED + 100),
        "arxiv_params": [{k: v.detach().cpu().numpy() for k, v in q.items()}
                         for q in amodel.params()],
        "arxiv_x": seeded((graphs["gorder"].n_rows, SERVE_DIMS[0]), SEED + 200),
        "arxiv_xw": seeded((graphs["gorder"].n_rows, REORDER_F), SEED + 6),
        "sddmm_x": seeded((graphs["gorder"].n_rows, SDDMM_ARXIV_D), SEED + 7),
        "arxiv_hybrid": hyb,
    }
    log(f"[dist] (b)-(f) {DIST_RANKS} ranks over gloo sharing the one GPU "
        f"(spawned; kernels built once, here) [{card_line}]")
    t0 = time.perf_counter()
    ranks = run_world(dist_rank, DIST_RANKS, backend="gloo", args=(cfg,),
                      timeout_s=900.0, threads=2)
    world_s = time.perf_counter() - t0
    r0 = ranks[0]
    for i, rec in enumerate(r0["runs"]):
        per_rank = [r["runs"][i]["ms"] for r in ranks]
        moved = [r["runs"][i]["bytes_received"] for r in ranks]
        model = ("" if rec["model_bytes"] is None else
                 f", comms model {rec['model_bytes']:.0f} bytes a rank")
        checks = ("" if "rel_plain" not in rec else
                  f"; stripe vs plain max |err| {max(r['runs'][i]['max_abs_err'] for r in ranks):.3e}"
                  + ("" if rec["rel_ref"] is None else
                     f", gathered C vs spmm_scipy rel {rec['rel_ref']:.3e}"))
        log(f"  dist {rec['name']}: {rec['strategy']}, transport {rec['transport']}, "
            f"plan {rec['plan_s']:.2f} s, ms a call per rank "
            f"{', '.join(f'{m:.2f}' for m in per_rank)} (4 ranks share one card: "
            f"not scaling numbers), exchange received {moved[0]} bytes a call "
            f"(rank 0){model}, {rec['host_round_trips']} host round trips, launches a rank {rec['launches']}{checks} [{card_line}]")
    for label, strategy in r0["auto"].items():
        log(f"  dist strategy='auto' on {label}: {strategy}")
    # the answers against the single-card ones on the same inputs
    ans = r0["answers"]
    with torch.no_grad():
        xd = torch.as_tensor(cfg["ddi_x"], device=DEV)
        checks = {}
        for tag, gate in (("f32", CHECK_EPS), ("int8", INT8_TOL)):
            want = ddi_model(ddi_plans[tag], xd)
            checks[f"ddi {tag}"] = (rel_to(torch.as_tensor(ans[f"ddi {tag}"], device=DEV),
                                           want), gate)
        amodel = amodel.to(DEV)
        xr = torch.as_tensor(cfg["arxiv_x"], device=DEV)
        for label, mat, impl in (("arxiv GCN hybrid gorder", hyb, "hybrid"),
                                 ("arxiv GCN csr_ell original",
                                  sym_norm_adjacency(graphs["original"]), "csr_ell")):
            want = amodel(spmm_plan(mat, impl=impl, grad=False, device=DEV), xr)
            checks[label] = (rel_to(torch.as_tensor(ans[label], device=DEV), want),
                             CHECK_EPS)
        xw = torch.as_tensor(cfg["arxiv_xw"], device=DEV)
        want = windowed_spmm_plan(divide_windowed(adj_g, tile_rows=256, window=1024),
                                  grad=False, device=DEV)(xw)
        checks["windowed"] = (rel_to(torch.as_tensor(ans["windowed"], device=DEV), want),
                              CHECK_EPS)
        xs_ = torch.as_tensor(cfg["sddmm_x"], device=DEV)
        want = sddmm(adj_g, xs_, xs_, device=DEV)
        checks["sddmm"] = (rel_to(torch.as_tensor(ans["sddmm"], device=DEV), want),
                           CHECK_EPS)
    for label, (rel, gate) in checks.items():
        log(f"  dist {label}: gathered answer vs the single-card one rel {rel:.3e} "
            f"(< {gate})")
        if not rel < gate:
            raise AssertionError(f"dist {label}: rel {rel:.3e} >= {gate}")
    seconds = time.perf_counter() - t_phase
    log(f"[dist] phase in {seconds:.1f} s (the world {world_s:.1f} s, its ranks "
        f"{', '.join(f'{r['seconds']:.1f}' for r in ranks)} s of work; rank 0 by "
        f"part: {', '.join(f'{k} {v:.1f} s' for k, v in r0['sections'].items())})")
    runs = []
    for i, rec in enumerate(r0["runs"]):
        runs.append({**{k: v for k, v in rec.items() if k != "max_abs_err"},
                     "ms_per_rank": [r["runs"][i]["ms"] for r in ranks],
                     "max_abs_err": max(r["runs"][i].get("max_abs_err", 0.0) for r in ranks)})
    return {"ranks": DIST_RANKS, "nccl_one_rank": a, "runs": runs,
            "sections": r0["sections"],
            "answers_rel": {k: v[0] for k, v in checks.items()}, "seconds": seconds}


# ---------------------------------------------------------------------------
# Phase 11, train-dist: the distributed training step (parallel/train.py),
# sharded checkpoints, dryrun_multichip, the scaling benches, the example
# ---------------------------------------------------------------------------

TD_STEPS = 3                    # Adam steps a case
# (e)'s worlds and shapes: the smallest grid that still starts each
# bench's rank function in a world of several ranks beside its one-rank
# baseline (JAX's default grid, worlds of 1, 2 and 4 at 1,024 block-rows
# of 64, took 120.5 s of the script's 1,200 on the H100)
TD_SCALING = [1, 2]
TD_DRYRUN_BLOCK_ROWS = 768      # (d)'s realistic pass, JAX's
TD_ARXIV_DIMS = SERVE_DIMS      # OGB's arxiv GCN
TD_MATCH_TOL = 1e-4             # (a): dist vs single-card losses and parameters
TD_SCALING_KW = dict(p=0.05, block_size=16, n_block_rows=32, dims=(16, 16, 4))
TD_ONE_RANK_BACKEND = "nccl"    # (a)'s process group


class _Sparse64(torch.autograd.Function):
    """A @ h in float64 on the host (scipy); its backward Aᵀ @ g."""

    @staticmethod
    def forward(ctx, h, a, at):
        ctx.at = at
        return torch.from_numpy(a @ h.detach().numpy())

    @staticmethod
    def backward(ctx, g):
        return torch.from_numpy(ctx.at @ g.numpy()), None, None


class ReluPattern(torch.overrides.TorchFunctionMode):
    """Records the inputs of torch.relu in call order; given masks (one a
    call, in that order), makes each call its input times the mask."""

    def __init__(self, masks=None):
        super().__init__()
        self.masks, self.inputs = masks, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.relu:
            z = args[0]
            if self.masks is not None:
                m = torch.as_tensor(self.masks[len(self.inputs)], dtype=z.dtype)
                self.inputs.append(z.detach())
                return z * m
            self.inputs.append(z.detach().clone())
        return func(*args, **(kwargs or {}))


def reference64(model: str, csr: CSR, params, x, y, mask, masks):
    """MODELS[model] in float64 on the host through the sparse A, as
    train_reference does for phase 5: (loss, the step-0 gradients in leaf
    order with every ReLU at `masks`, the kernel run's activation
    pattern, then how that pattern compares with float64's own: the
    count of signs that differ and the largest |z64| among them, relative
    to max |z64|)."""
    from spmm_denseblock_tpu_torch.models import MODELS

    a = csr.to_scipy().astype(np.float64).tocsr()
    at = a.T.tocsr()
    out = []
    for fixed in (masks, None):
        p64 = tree_map(lambda t: torch.tensor(np.asarray(t), dtype=torch.float64,
                                              requires_grad=True), params)
        with ReluPattern(fixed) as rp:
            logits = MODELS[model][1](p64, lambda h: _Sparse64.apply(h, a, at),
                                      torch.as_tensor(x).double())
        loss = masked_cross_entropy(logits, torch.as_tensor(y),
                                    torch.as_tensor(mask).double())
        loss.backward()
        out.append((loss.item(), [t.grad.numpy() for t in tree_leaves(p64)], rp.inputs))
    (loss, grads, _), (_, _, z64s) = out
    flips, flipped = 0, 0.0
    for m, z64 in zip(masks, z64s):
        f = (z64.numpy() > 0) != m
        flips += int(f.sum())
        if f.any():
            flipped = max(flipped, float(np.abs(z64.numpy()[f]).max() / z64.abs().max()))
    return loss, grads, (flips, flipped)


def leaf_rel(got: list, want: list) -> float:
    """The largest max |err| / max |ref| over the leaves."""
    return max(float(np.abs(np.asarray(g, np.float64) - w).max()
                     / max(np.abs(w).max(), 1e-30)) for g, w in zip(got, want))


def whole_numpy(tree) -> list:
    return [t.detach().cpu().numpy() for t in tree_leaves(tree)]


def train_dist_one_rank(adj: CSR, dims, train_f32, card_line: str) -> dict:
    """Phase 11 (a): one NCCL rank in this process. The ddi GCN through
    make_dist_train_step (allgather, n = 1, the xla local product) and
    the single-card make_train_step on the bsr_xla plan (the same
    arithmetic: JAX's test_dist_matches_single_chip holds its step to
    that tier) from the same weights, both with torch's deterministic
    algorithms: 3 Adam steps each, losses and parameters within
    TD_MATCH_TOL; step 0's gradients within GRAD_TOL of float64 at the
    dist run's ReLU pattern; no kernel launched by the dist steps. Then
    the same 3 steps of phase 5's f32 step (K2 both ways) from the same
    weights, its distance printed (Adam turns rounding-level gradient
    differences into parameter differences of about 3e-4 after 3 steps:
    it is no gate), and the dist step timed beside it (order phase 5,
    dist, dist, phase 5)."""
    import tempfile

    import torch.distributed as dist

    from spmm_denseblock_tpu_torch.parallel import make_mesh_1d
    from spmm_denseblock_tpu_torch.parallel.train import make_dist_train_step

    t_plan, _, _, _, batch = train_f32
    n = adj.n_rows
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    y = rng.integers(0, dims[-1], size=n).astype(np.int64)
    mask = (rng.random(n) < 0.6).astype(np.float32)
    whole = [{k: v.numpy() for k, v in p.items()}
             for p in init_gcn(dims, generator=torch.Generator().manual_seed(SEED + 30))]

    def single(plan):
        params = [{k: torch.tensor(v, device=DEV) for k, v in p.items()} for p in whole]
        step, init = make_train_step(gcn_apply, plan,
                                     functools.partial(torch.optim.Adam, lr=1e-2))
        opt = init(params)
        losses = []
        for _ in range(TD_STEPS):
            params, opt, m = step(params, opt, *batch)
            losses.append(m["loss"].item())
        return losses, params, lambda: step(params, opt, *batch)

    store = tempfile.mkdtemp(prefix="sdb_nccl_")
    dist.init_process_group(TD_ONE_RANK_BACKEND, init_method=f"file://{store}/store",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh_1d(1, device_type=DEV)
        params, opt, step = make_dist_train_step(adj, mesh, dims, block_size=128,
                                                 params=whole, device=DEV)
        with torch.no_grad():
            zs = preactivations(params, step.spmm, batch[0])
        ref = train_reference(adj, params, x, y, mask, zs)
        with warnings.catch_warnings():
            # cuBLAS's note that it is deterministic only with a workspace
            # setting made before its first use; the index ops are
            warnings.simplefilter("ignore", UserWarning)
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                reset_launches()
                losses = []
                for i in range(TD_STEPS):
                    params, opt, m = step(params, opt, *batch)
                    losses.append(m["loss"].item())
                    if i == 0:
                        check_step0("dist n=1", params, ref, losses[0], FLIP_CAP[None])
                _sync()
                counts = {k: v for k, v in launches().items() if v}
                x_losses, x_params, _ = single(spmm_plan(adj, impl="bsr_xla",
                                                         block_size=128, device=DEV))
            finally:
                torch.use_deterministic_algorithms(False)
        if DEV == "cuda" and counts:
            raise AssertionError(f"train-dist (a): the xla steps launched {counts}")
        k_losses, k_params, k_step = single(t_plan)
        rel = {}
        for key, (ls, ps) in (("bsr_xla", (x_losses, x_params)),
                              ("K2", (k_losses, k_params))):
            rel[key] = (max(abs(a - b) / abs(b) for a, b in zip(losses, ls)),
                        leaf_rel(whole_numpy(params), whole_numpy(ps)))
        log(f"  train-dist (a) losses {' '.join(f'{v:.6f}' for v in losses)}; single "
            f"card bsr_xla {' '.join(f'{v:.6f}' for v in x_losses)}: rel "
            f"{rel['bsr_xla'][0]:.3e}, parameters after {TD_STEPS} steps within "
            f"{rel['bsr_xla'][1]:.3e} (< {TD_MATCH_TOL}); phase 5's f32 step (K2) "
            f"{' '.join(f'{v:.6f}' for v in k_losses)}: rel {rel['K2'][0]:.3e}, "
            f"parameters within {rel['K2'][1]:.3e} (no gate)")
        if not max(rel["bsr_xla"]) < TD_MATCH_TOL:
            raise AssertionError(f"train-dist (a): dist vs single card bsr_xla: loss rel "
                                 f"{rel['bsr_xla'][0]:.3e}, parameters {rel['bsr_xla'][1]:.3e}")
        k1 = cuda_ms(k_step, iters=10)
        d1 = cuda_ms(lambda: step(params, opt, *batch), iters=10)
        d2 = cuda_ms(lambda: step(params, opt, *batch), iters=10)
        k2 = cuda_ms(k_step, iters=10)
        log(f"  train-dist (a) ms a step: dist n=1 (xla stripes) {(d1 + d2) / 2:.3f}, "
            f"phase 5's single-card f32 step (K2 both ways) {(k1 + k2) / 2:.3f} (order "
            f"single, dist, dist, single: {k1:.3f}, {d1:.3f}, {d2:.3f}, {k2:.3f}) "
            f"[{card_line}]")
        return {"losses": losses, "bsr_xla_losses": x_losses, "k2_losses": k_losses,
                "loss_rel": rel["bsr_xla"][0], "param_rel": rel["bsr_xla"][1],
                "k2_loss_rel": rel["K2"][0], "k2_param_rel": rel["K2"][1],
                "dist_ms": (d1 + d2) / 2, "single_ms": (k1 + k2) / 2,
                "runs": [k1, d1, d2, k2]}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def _td_case(rank: int, case: dict, meshes: dict, dev: str) -> dict:
    """One case's TD_STEPS steps on this rank: losses, ms a step, the
    exchange's bytes, launches, and (rank 0) the gathered step-0
    gradients."""
    import torch.distributed as dist

    from spmm_denseblock_tpu_torch.parallel.comms import comms_bytes_per_device
    from spmm_denseblock_tpu_torch.parallel.train import make_dist_train_step

    t0 = time.perf_counter()
    params, opt, step = make_dist_train_step(
        case["adj"], meshes[case["mesh"]], case["dims"], model=case["model"],
        block_size=128, strategy=case["strategy"], params=case["params"], device=dev)
    plan_s = time.perf_counter() - t0
    x, y, mask = (torch.as_tensor(a) for a in (case["x"], case["y"], case["mask"]))
    reset_launches()
    out = {"name": case["name"], "losses": [], "ms": [], "plan_s": plan_s,
           "chained": step.chained}
    for i in range(TD_STEPS):
        dist.barrier()
        _sync()
        t0 = time.perf_counter()
        with ReluPattern() if i == 0 else contextlib.nullcontext() as rp:
            params, opt, m = step(params, opt, x, y, mask)
        out["losses"].append(m["loss"].item())
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            out["bytes"] = m["exchange_bytes"]
            grads = step.whole(tree_map(lambda t: t.grad, params))
            # step 0's activation pattern, whole: each ReLU input's rows
            # assembled over the row group, its columns over col
            masks = [_whole_rows(step, z) > 0 for z in rp.inputs]
            if rank == 0:
                out["grads0"] = whole_numpy(grads)
                out["masks"] = [(np.packbits(m.cpu().numpy()), tuple(m.shape))
                                for m in masks]
    _sync()
    out["launches"] = {k: v for k, v in launches().items() if v}
    if dev == "cuda" and out["launches"]:
        raise AssertionError(f"train-dist {case['name']}: launched {out['launches']}")
    info = step.info
    K = info.split.chunk * info.n
    kind = case["strategy"]
    widths = case["dims"][:-1]
    per = [comms_bytes_per_device(kind, info.n, K, -(-F // info.tp)) for F in widths]
    out["model_bytes"] = {"forward": sum(per), "backward": sum(per[1:])}
    return out


def _whole_rows(step, z: torch.Tensor) -> torch.Tensor:
    """An activation of the step's layout (this rank's output rows, its
    feature slice) whole on every rank."""
    from spmm_denseblock_tpu_torch.parallel import exchange as exch

    info = step.info
    full = exch.assemble_rows(info, z, info.out_rows, info.n_rows)
    if step.tp > 1:
        full = exch.gather_columns(full, step.col_group, step._width(z))
    return full


def _td_checkpoint(rank: int, case: dict, meshes: dict, dev: str, root: str) -> dict:
    """(c): TD_STEPS - 1 steps, a save, the uninterrupted last step; a
    fresh template (other weights, no optimizer state) restored and its
    last step, which must equal the uninterrupted one bit for bit (the
    steps run with torch's deterministic algorithms)."""
    from spmm_denseblock_tpu_torch.models import (
        make_manager,
        restore_dist_checkpoint,
        save_dist_checkpoint,
    )
    from spmm_denseblock_tpu_torch.parallel.train import make_dist_train_step

    torch.use_deterministic_algorithms(True, warn_only=True)
    build = functools.partial(make_dist_train_step, case["adj"], meshes[case["mesh"]],
                              case["dims"], model=case["model"], block_size=128,
                              strategy=case["strategy"], device=dev)
    x, y, mask = (torch.as_tensor(a) for a in (case["x"], case["y"], case["mask"]))
    params, opt, step = build(params=case["params"])
    for _ in range(TD_STEPS - 1):
        params, opt, _ = step(params, opt, x, y, mask)
    mgr = make_manager(root, max_to_keep=2)
    t0 = time.perf_counter()
    save_dist_checkpoint(mgr, TD_STEPS - 1, step.state(params, opt))
    save_s = time.perf_counter() - t0
    params, opt, m = step(params, opt, x, y, mask)
    p2, o2, s2 = build(seed=SEED + 99)
    t0 = time.perf_counter()
    _, k = restore_dist_checkpoint(mgr, s2.state(p2, o2))
    restore_s = time.perf_counter() - t0
    p2, o2, m2 = s2(p2, o2, x, y, mask)
    torch.use_deterministic_algorithms(False)
    same = (m["loss"].item() == m2["loss"].item() and
            all(torch.equal(a.detach(), b.detach())
                for a, b in zip(tree_leaves(params), tree_leaves(p2))))
    if k != TD_STEPS - 1 or not same:
        raise AssertionError(f"train-dist (c) rank {rank}: step {k}, the restored "
                             f"step {TD_STEPS} not bit-equal to the uninterrupted one")
    files = sorted(Path(mgr.step_dir(k)).glob(f"__{rank}_*.distcp"))
    shards = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    return {"save_s": save_s, "restore_s": restore_s,
            "file_bytes": sum(f.stat().st_size for f in files),
            "shard_bytes": 3 * shards}  # the parameters, Adam's mu and nu


def train_dist_rank(rank: int, n: int, cfg: dict) -> dict:
    """Phase 11 (b) and (c) on one of the world's ranks, all sharing the
    one GPU over gloo."""
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # (c)
    from spmm_denseblock_tpu_torch.parallel import make_mesh

    global DEV
    DEV = dev = cfg["device"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev == "cuda":
        _kernels.load()
    meshes = {"4x1": make_mesh((4, 1), device_type=dev),
              "2x2": make_mesh((2, 2), device_type=dev)}
    out = {"cases": [], "seconds": {}}
    for case in cfg["cases"]:
        t0 = time.perf_counter()
        out["cases"].append(_td_case(rank, case, meshes, dev))
        out["seconds"][case["name"]] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["checkpoint"] = _td_checkpoint(rank, cfg["cases"][cfg["ckpt_case"]], meshes,
                                       dev, cfg["ckpt_dir"])
    out["seconds"]["(c) checkpoints"] = time.perf_counter() - t0
    return out


def train_dist_phase(ddi: CSR, ddi_adj: CSR, dims, train_f32, graphs: dict,
                     card_line: str) -> dict:
    """Phase 11: (a) one NCCL rank here; (b)-(c) four gloo ranks spawned
    on the one GPU; (d) dryrun_multichip(4); (e) the scaling benches at
    their smallest grid (TD_SCALING); (f) the dist_train example and its
    resume.
    Returns the train_dist JSON line's object."""
    import tempfile

    from spmm_denseblock_tpu_torch.bench import bench_scaling, bench_train_scaling
    from spmm_denseblock_tpu_torch.entry import dryrun_multichip
    from spmm_denseblock_tpu_torch.examples import dist_train
    from spmm_denseblock_tpu_torch.models import GIN
    from spmm_denseblock_tpu_torch.parallel.world import run_world

    t_phase = time.perf_counter()
    secs = {}
    log(f"[train-dist] (a) one rank over NCCL: ddi GCN {dims} [{card_line}]")
    a = train_dist_one_rank(ddi_adj, dims, train_f32, card_line)
    secs["(a)"] = time.perf_counter() - t_phase

    # (b): the ddi encoder's widths (GCN and GIN on sym_norm_adjacency, a
    # sum aggregator kept at the GCN's scale; SAGE on mean_adjacency) and
    # the arxiv GCN on the serve phase's gorder hybrid; weights made here
    t0 = time.perf_counter()
    n = ddi_adj.n_rows
    rng = np.random.default_rng(SEED)
    ddi_batch = {"x": rng.standard_normal((n, dims[0])).astype(np.float32),
                 "y": rng.integers(0, dims[-1], size=n).astype(np.int64),
                 "mask": (rng.random(n) < 0.6).astype(np.float32)}
    g = graphs["gorder"]
    arng = np.random.default_rng(SEED + 40)
    arxiv_batch = {"x": seeded((g.n_rows, TD_ARXIV_DIMS[0]), SEED + 200),
                   "y": arng.integers(0, TD_ARXIV_DIMS[-1], size=g.n_rows).astype(np.int64),
                   "mask": (arng.random(g.n_rows) < 0.6).astype(np.float32)}
    adj_g = sym_norm_adjacency(g)
    mean = mean_adjacency(ddi)

    def weights(model_cls, d, seed):
        m = model_cls(d, generator=torch.Generator().manual_seed(seed))
        return tree_map(lambda t: t.detach().numpy(), m.params())

    w = {"gcn": weights(GCN, dims, SEED + 31), "sage": weights(SAGE, dims, SEED + 32),
         "gin": weights(GIN, dims, SEED + 33),
         "arxiv": weights(GCN, TD_ARXIV_DIMS, SEED + 34)}
    cases = [
        {"name": "ddi GCN (4, 1) allgather", "model": "gcn", "mesh": "4x1",
         "strategy": "allgather", "adj": ddi_adj, "csr": ddi_adj, "params": w["gcn"],
         "dims": dims, **ddi_batch},
        {"name": "ddi GCN (4, 1) ring", "model": "gcn", "mesh": "4x1",
         "strategy": "ring", "adj": ddi_adj, "csr": ddi_adj, "params": w["gcn"],
         "dims": dims, **ddi_batch},
        {"name": "ddi GCN (2, 2) allgather, feature axis", "model": "gcn",
         "mesh": "2x2", "strategy": "allgather", "adj": ddi_adj, "csr": ddi_adj,
         "params": w["gcn"], "dims": dims, **ddi_batch},
        {"name": "ddi SAGE (2, 2) allgather, feature axis", "model": "sage",
         "mesh": "2x2", "strategy": "allgather", "adj": mean, "csr": mean,
         "params": w["sage"], "dims": dims, **ddi_batch},
        {"name": "ddi GIN (2, 2) allgather, feature axis", "model": "gin",
         "mesh": "2x2", "strategy": "allgather", "adj": ddi_adj, "csr": ddi_adj,
         "params": w["gin"], "dims": dims, **ddi_batch},
        {"name": "arxiv GCN (4, 1) allgather, gorder hybrid", "model": "gcn",
         "mesh": "4x1", "strategy": "allgather",
         "adj": _explicit_hybrid(adj_g, "hybrid", 128, {}), "csr": adj_g,
         "params": w["arxiv"], "dims": TD_ARXIV_DIMS, **arxiv_batch},
    ]
    ckpt_root = tempfile.mkdtemp(prefix="sdb_ckpt_")
    cfg = {"device": DEV, "cases": [{k: v for k, v in c.items() if k != "csr"}
                                    for c in cases],
           "ckpt_case": 2, "ckpt_dir": ckpt_root}
    log(f"[train-dist] (b)-(c) {DIST_RANKS} ranks over gloo sharing the one GPU "
        f"[{card_line}]")
    t0 = time.perf_counter()
    try:
        ranks = run_world(train_dist_rank, DIST_RANKS, backend="gloo", args=(cfg,),
                          timeout_s=900.0, threads=2)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    secs["(b)-(c) world"] = time.perf_counter() - t0
    runs = []
    for i, case in enumerate(cases):
        per = [r["cases"][i] for r in ranks]
        r0 = per[0]
        masks = [np.unpackbits(bits)[:int(np.prod(shape))].reshape(shape).astype(bool)
                 for bits, shape in r0["masks"]]
        loss64, grads64, (flips, flipped) = reference64(
            case["model"], case["csr"], case["params"], case["x"], case["y"],
            case["mask"], masks)
        grad_rel = leaf_rel(r0["grads0"], grads64)
        same = all(p["losses"] == r0["losses"] for p in per)
        falls = r0["losses"][-1] < r0["losses"][0]
        ms = [float(np.mean(p["ms"][1:])) for p in per]
        log(f"  train-dist {case['name']}: losses {' '.join(f'{v:.6f}' for v in r0['losses'])}"
            f" (float64 step 0 {loss64:.6f}), equal on every rank: {same}; step-0 "
            f"gradients within {grad_rel:.3e} of float64 at the run's ReLU pattern (< "
            f"{GRAD_TOL}); {flips} ReLU inputs change sign against float64's, the "
            f"largest |z64| among them {flipped:.3e} of max (<= {FLIP_REL:.3e}); ms a step per "
            f"rank {', '.join(f'{m:.1f}' for m in ms)} (step 0: "
            f"{', '.join(f'{p['ms'][0]:.1f}' for p in per)}; 4 ranks share one card: "
            f"not scaling numbers); bytes received by rank 0 in step 0: forward "
            f"{r0['bytes']['forward']}, backward {r0['bytes']['backward']}, gradient "
            f"sums {r0['bytes']['grads']}, beside the SpMM exchanges' reckoning "
            f"(comms_bytes_per_device) {r0['model_bytes']['forward']:.0f} / "
            f"{r0['model_bytes']['backward']:.0f}; rows {'chained' if r0['chained'] else 'redistributed'}; "
            f"plan {r0['plan_s']:.2f} s; launches {r0['launches']} [{card_line}]")
        if not (same and falls and grad_rel < GRAD_TOL and flipped <= FLIP_REL):
            raise AssertionError(f"train-dist {case['name']}: losses equal {same}, "
                                 f"falling {falls}, gradient rel {grad_rel:.3e}, flips "
                                 f"{flips} up to {flipped:.3e} of max |z64|")
        runs.append({"name": case["name"], "losses": r0["losses"], "loss64": loss64,
                     "grad_rel": grad_rel, "relu_flips": flips, "ms_per_rank": ms,
                     "step0_ms_per_rank": [p["ms"][0] for p in per],
                     "bytes": r0["bytes"], "model_bytes": r0["model_bytes"],
                     "chained": r0["chained"], "plan_s": r0["plan_s"]})
    ck = [r["checkpoint"] for r in ranks]
    log(f"  train-dist (c) checkpoints of {cases[cfg['ckpt_case']]['name']}: the "
        f"restored step {TD_STEPS} equal to the uninterrupted one bit for bit on every "
        f"rank; bytes written per rank {', '.join(str(c['file_bytes']) for c in ck)} "
        f"beside its shards' {', '.join(str(c['shard_bytes']) for c in ck)}; seconds "
        f"per save {max(c['save_s'] for c in ck):.2f}, per restore "
        f"{max(c['restore_s'] for c in ck):.2f} [{card_line}]")
    for label, v in ranks[0]["seconds"].items():
        secs[f"rank 0 {label}"] = v

    t0 = time.perf_counter()
    log(f"[train-dist] (d) dryrun_multichip({DIST_RANKS}) [{card_line}]")
    dry = dryrun_multichip(DIST_RANKS, DEV, realistic_block_rows=TD_DRYRUN_BLOCK_ROWS)
    secs["(d)"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    train_sc = bench_train_scaling(TD_SCALING, device=DEV, **TD_SCALING_KW)
    spmm_sc = bench_scaling(TD_SCALING, device=DEV,
                            **{k: v for k, v in TD_SCALING_KW.items() if k != "dims"})
    for rec in (train_sc, spmm_sc):
        pts = "; ".join(
            f"{p['devices']} ranks {p.get('ms_per_step', p.get('ms')):.2f} ms, retention "
            f"{p['retention']:.3f}" for p in rec["points"])
        log(f"  train-dist (e) {rec['kind']} (nnzb {rec['nnzb']}, {rec['strategy']}): "
            f"{pts} [{card_line}]")
    secs["(e)"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ex_dir = tempfile.mkdtemp(prefix="sdb_example_")
    try:
        base = ["--ranks", str(DIST_RANKS), "--ckpt-dir", ex_dir, "--ckpt-every", "1",
                "--device", DEV]
        first = dist_train.main(base + ["--epochs", "2"])
        resumed = dist_train.main(base + ["--epochs", "3"])
    finally:
        shutil.rmtree(ex_dir, ignore_errors=True)
    if first["start"] != 0 or resumed["start"] != 2 or len(resumed["losses"]) != 1:
        raise AssertionError(f"train-dist (f): {first}, {resumed}")
    log(f"  train-dist (f) examples.dist_train: 2 epochs (losses "
        f"{' '.join(f'{v:.4f}' for v in first['losses'])}), resumed at epoch "
        f"{resumed['start']} (loss {resumed['losses'][0]:.4f}) [{card_line}]")
    secs["(f)"] = time.perf_counter() - t0
    seconds = time.perf_counter() - t_phase
    log(f"[train-dist] phase in {seconds:.1f} s ({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    return {"ranks": DIST_RANKS, "one_rank_nccl": a, "runs": runs,
            "checkpoint": ck, "dryrun": dry, "train_scaling": train_sc,
            "scaling": spmm_sc, "example": {"first": first, "resumed": resumed},
            "seconds": seconds, "sections": secs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = card()
    kind = torch.cuda.get_device_name(0)
    log(f"[setup] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind}")
    log(f"[setup] nvidia-smi: {card_line}")

    t0 = time.perf_counter()
    libs = _kernels.build()
    _kernels.load()
    log(f"[build] {', '.join(str(p.relative_to(ROOT)) for p in libs)} in "
        f"{time.perf_counter() - t0:.1f} s")
    t_phase = phase_done("1-2 set-up and build", t_start)

    t0 = time.perf_counter()
    ddi = ddi_graph(ROOT / "build" / "datasets")
    adj = sym_norm_adjacency(ddi)
    log(f"[setup] ddi adjacency in {time.perf_counter() - t0:.1f} s")
    kernel_phase(adj)

    op_bsr = random_bsr(2e-2, 1024, 1024, block_size=128, seed=SEED)
    F = 512
    dense = seeded((op_bsr.shape[1], F), SEED)
    x_op = torch.as_tensor(dense, device=DEV)
    t0 = time.perf_counter()
    op_csr = random_csr(2e-3, op_bsr.shape[1], seed=SEED)
    log(f"[setup] random_csr(2e-3, 2^17) in {time.perf_counter() - t0:.1f} s")
    t_phase = phase_done("3 kernels (and the op shape's set-up)", t_phase)
    dims = [256, 256, 256]
    (slices, model, xs, train, plans, errs, main_launches, slice_errs,
     reorder_rows, sp, mp, dp, graphs) = main_path(ddi, adj, dims, op_bsr, op_csr, x_op,
                                                   dense[:4096], card_line)
    t_phase = time.perf_counter()

    # ---- timing (after the counts were read) ----------------------------
    log(f"[timing] card: {card_line}")
    t0 = time.perf_counter()
    serve_rows = serve_timing(sp, sp["launched"], card_line)
    log(f"[serve] timing in {time.perf_counter() - t0:.1f} s")
    del sp
    torch.cuda.empty_cache()
    model_rows = models_timing(mp, card_line)
    del mp
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    default_rows = default_timing(dp, card_line)
    log(f"[default] timing in {time.perf_counter() - t0:.1f} s")
    del dp
    torch.cuda.empty_cache()
    x0 = xs[0]
    ddi_flops = {"f32": 2.0 * calculate_nnzb(adj, 128) * 128 * 128 * dims[0],
                 "csr": 2.0 * adj.nnz * dims[0]}
    ddi_flops["int8"] = ddi_flops["bf16"] = ddi_flops["f32"]
    request_ms, spmm_ms = {}, {}
    with torch.no_grad():
        for tag, p in slices.items():
            request_ms[tag] = cuda_ms(lambda: model(p, x0), iters=20)
            gcn_plain_ms = cuda_ms(
                lambda: model(lambda h: plain_apply(p, h), x0), iters=20)
            spmm_ms[tag] = cuda_ms(lambda: p(x0), iters=20)
            spmm_plain_ms = cuda_ms(lambda: plain_apply(p, x0), iters=20)
            log(f"  slice GCN request {tag} (X on device): kernel "
                f"{request_ms[tag]:.3f} ms, plain {gcn_plain_ms:.3f} ms [{card_line}]")
            log(f"  slice A @ H, F={dims[0]} {tag} {kernel_of(p)[0]}: kernel "
                f"{spmm_ms[tag]:.3f} ms {ddi_flops[tag] / spmm_ms[tag] / 1e6:.1f} "
                f"GFLOP/s, plain {spmm_plain_ms:.3f} ms "
                f"{ddi_flops[tag] / spmm_plain_ms / 1e6:.1f} GFLOP/s [{card_line}]")
        k10_ddi = library_ms("csr", adj, x0, slices["csr"](x0), 20,
                             f"ddi torch.sparse_csr_tensor @ X, F={dims[0]}")
        if k10_ddi is not None:
            log(f"  slice A @ H csr library {ddi_flops['csr'] / k10_ddi / 1e6:.1f} "
                f"GFLOP/s [{card_line}]")
        # the int8 SpMM call's parts at ddi: the quantization kernel (the
        # operand transposed, dynamic scales), the ring alone, and the
        # plain version of the quantization (PyTorch ops and the copy)
        p8 = slices["int8"]
        n8 = p8.statics[4]
        qt, cs = quantize_int8(x0, n8, None, True)
        log(f"  slice A @ H, F={dims[0]} int8 K7 call in parts: quantize_int8 "
            f"{cuda_ms(lambda: quantize_int8(x0, n8, None, True), iters=20):.3f} "
            f"ms, ring alone "
            f"{cuda_ms(lambda: run_quantized(p8, None, cs, qdense_t=qt), iters=20):.3f}"
            f" ms, the whole call {cuda_ms(lambda: p8(x0), iters=20):.3f} ms; the "
            f"quantization's plain version (PyTorch ops and the transposed copy) "
            f"{cuda_ms(lambda: quantize_int8_plain(x0, n8, None, True), iters=20):.3f}"
            f" ms (each a stream of 20 calls) [{card_line}]")
        p9 = bsr_spmm_pallas_int8_plan(csr_to_bsr(adj, 128), resident=True,
                                       f_tile=128, device=DEV)
        qt, cs = quantize_operand(p9, x0, transposed=True)
        q = quantize_operand(p9, x0)[0]
        log(f"  slice A @ H, F={dims[0]} int8 K9 (resident=True, f_tile=128): ring "
            f"{cuda_ms(lambda: run_quantized(p9, None, cs, qdense_t=qt), iters=20):.3f}"
            f" ms, whole call {cuda_ms(lambda: p9(x0), iters=20):.3f} ms, plain "
            f"{cuda_ms(lambda: run_quantized(p9, q, cs, plain=True), iters=5):.3f}"
            f" ms [{card_line}]")
        ddi_bound = csr_bound(adj, dims[0])
        log(f"  slice A @ H K10 bound {ddi_bound[0]:.4f} ms ({ddi_bound[1]}); K2 "
            f"bound {bsr_bound('f32', csr_to_bsr(adj, 128), dims[0])[0]:.4f} ms")
        log(f"  ddi csr vs bsr: request {request_ms['csr'] / request_ms['f32']:.3f}x, "
            f"A @ H {spmm_ms['csr'] / spmm_ms['f32']:.3f}x (K10 / K2) [{card_line}]")
    step_ms = {}
    for key, (t_plan, step, state, params, batch) in train.items():
        step_ms[key] = cuda_ms(lambda: step(params, state, *batch), iters=20)
        plain_step, plain_init = make_train_step(
            gcn_apply, lambda h: plain_apply(t_plan, h),
            functools.partial(torch.optim.Adam, lr=1e-2))
        p2 = [{k: v.detach().clone() for k, v in p.items()} for p in params]
        s2 = plain_init(p2)
        plain_ms = cuda_ms(lambda: plain_step(p2, s2, *batch), iters=10)
        log(f"  train step {key} ({kernel_of(t_plan.arrays[0])[0]} both ways, "
            f"Adam): kernel {step_ms[key]:.3f} ms, plain {plain_ms:.3f} ms "
            f"[{card_line}]")
    log(f"  ddi csr vs bsr: training step {step_ms['csr'] / step_ms['f32']:.3f}x "
        f"[{card_line}]")

    op_flops = 2.0 * op_bsr.nnzb * 128 * 128 * F
    # per kernel instance, keyed (tag, layout) as the op plans are
    times, bounds, library, whole = {}, {}, {}, {}
    f32_ref = plans[("f32", "sorted")](x_op)
    lib_ms = {
        "f32": library_ms("bsr", op_bsr, x_op, f32_ref, 2,
                          "op torch.sparse_bsr_tensor @ X, f32"),
        "bf16": library_ms("bsr", op_bsr, x_op.to(torch.bfloat16), f32_ref, 10,
                           "op torch.sparse_bsr_tensor @ X, bf16"),
    }
    lib_ms["high"] = lib_ms["f32"]
    # K3's operand split alone: it runs in every K3 call timed below
    key = ("split", "split")
    ld = -(-F // 8) * 8
    times[key] = (cuda_ms(lambda: split_operand(x_op), iters=20),
                  cuda_ms(lambda: split_operand_plain(x_op), iters=5, warmup=1))
    bounds[key] = bound("f32", 0.0, x_op.numel() * 4 + 2 * x_op.shape[0] * ld * 2)
    library[key] = None
    log(f"  op K3 operand split ({x_op.shape[0]} x {F} f32 -> 2 x {x_op.shape[0]} "
        f"x {ld} bf16) split_bf16 kernel {times[key][0]:.3f} ms, plain "
        f"{times[key][1]:.3f} ms, bound {bounds[key][0]:.3f} ms ({bounds[key][1]}), "
        f"library none [{card_line}]")
    for (tag, layout), p in plans.items():
        kid, name = kernel_of(p)[:2]
        if tag == "csr":
            continue
        if tag == "int8":
            q, cs = quantize_operand(p, x_op)
            p_ms = cuda_ms(lambda: run_quantized(p, q, cs, plain=True),
                           iters=5, warmup=1)
            # the ring alone on the operand quantized transposed
            # beforehand, and the whole call (static quantization by
            # quantize_int8, then the ring), in the order ring, call,
            # call, ring
            qt = quantize_operand(p, x_op, transposed=True)[0]
            k1 = cuda_ms(lambda: run_quantized(p, None, cs, qdense_t=qt), iters=10)
            w1 = cuda_ms(lambda: p(x_op), iters=10)
            w2 = cuda_ms(lambda: p(x_op), iters=10)
            k2 = cuda_ms(lambda: run_quantized(p, None, cs, qdense_t=qt), iters=10)
            k_ms, whole_ms = (k1 + k2) / 2, (w1 + w2) / 2
            whole[(tag, layout)] = whole_ms
            extra = (f", BN={tile_bn(name, op_bsr, F)}, {p.arrays[2].shape[0]} "
                     f"slots, ring runs {k1:.3f}, {k2:.3f} ms, whole call with "
                     f"static quantization {whole_ms:.3f} ms ({w1:.3f}, {w2:.3f})")
        elif tag == "bf16":  # on the bf16 operand, as the library call
            x_bf = x_op.to(torch.bfloat16)
            p_ms = cuda_ms(lambda: plain_apply(p, x_bf), iters=5, warmup=1)
            # in the order kernel, whole, whole, kernel, so that a drift of
            # the card's clocks over the four shows as a spread of the pairs
            k1 = cuda_ms(lambda: p(x_bf), iters=10)
            w1 = cuda_ms(lambda: p(x_op), iters=10)
            w2 = cuda_ms(lambda: p(x_op), iters=10)
            k2 = cuda_ms(lambda: p(x_bf), iters=10)
            k_ms, whole_ms = (k1 + k2) / 2, (w1 + w2) / 2
            extra = (f", kernel runs {k1:.3f}, {k2:.3f} ms, whole call from the "
                     f"f32 operand {whole_ms:.3f} ms ({w1:.3f}, {w2:.3f})")
        else:
            k_ms = cuda_ms(lambda: p(x_op), iters=10)
            p_ms = cuda_ms(lambda: plain_apply(p, x_op), iters=5, warmup=1)
            extra = (f", BN={tile_bn(name, op_bsr, F)}" if tile_bn(name, op_bsr, F)
                     else "")
            if tag == "high":
                extra += (f", the operand split included "
                          f"({times[('split', 'split')][0]:.3f} ms alone)")
            else:  # the slots the FFMA loop runs, zero pads included
                extra += f", {p.arrays[2].shape[0]} slots"
        key = (tag, layout)
        times[key] = (k_ms, p_ms)
        bounds[key] = bsr_bound(tag, op_bsr, F)
        library[key] = lib_ms.get(tag)
        lib = "none" if library[key] is None else f"{library[key]:.3f} ms"
        log(f"  op {tag:<4} {layout:<8} {kid} {name:<26} kernel {k_ms:.3f} ms "
            f"{op_flops / k_ms / 1e6:.1f} GFLOP/s, plain {p_ms:.3f} ms "
            f"{op_flops / p_ms / 1e6:.1f} GFLOP/s, bound {bounds[key][0]:.3f} ms "
            f"({bounds[key][1]}), library {lib}{extra} [{card_line}]")
    key = ("csr", "csr")
    p = plans[key]
    k_ms = cuda_ms(lambda: p(x_op), iters=5)
    p_ms = cuda_ms(lambda: plain_apply(p, x_op), iters=2, warmup=1)
    csr_flops = 2.0 * op_csr.nnz * F
    times[key] = (k_ms, p_ms)
    bounds[key] = csr_bound(op_csr, F)
    library[key] = library_ms("csr", op_csr, x_op, p(x_op), 5,
                              "op torch.sparse_csr_tensor @ X, f32")
    W = csr_strip_width(op_csr.n_cols, F, _l2_bytes(0))
    lib = "none" if library[key] is None else f"{library[key]:.3f} ms"
    log(f"  op csr K10 csr_spmm kernel {k_ms:.3f} ms {csr_flops / k_ms / 1e6:.1f} "
        f"GFLOP/s, strips of W={W} ({-(-F // W)} strips, L2 {_l2_bytes(0)} bytes), "
        f"plain {p_ms:.3f} ms {csr_flops / p_ms / 1e6:.1f} GFLOP/s, bound "
        f"{bounds[key][0]:.3f} ms ({bounds[key][1]}), library {lib} [{card_line}]")
    # the int8 operand's quantization at the op shape: quantize_int8 into
    # the ring's (F, N) layout, dynamic and static, against its plain
    # version (PyTorch's ops and the transposed copy) and its bound: the
    # operand read once, the int8 operand written once and the scales read
    # (static) or written (dynamic) once. The two-pass design reads the
    # operand twice with dynamic scales, which the line gives beside it.
    cs_static = plans[("int8", "sorted")].arrays[-1]
    n_op = plans[("int8", "sorted")].statics[4]
    x_bytes, q_bytes = x_op.numel() * 4, n_op * F
    for key, cs in ((("quantize", "dynamic"), None),
                    (("quantize", "static"), cs_static)):
        times[key] = (
            cuda_ms(lambda: quantize_int8(x_op, n_op, cs, True), iters=20),
            cuda_ms(lambda: quantize_int8_plain(x_op, n_op, cs, True), iters=5))
        bounds[key] = bound("int8", 0.0, x_bytes + q_bytes + F * 4)
        library[key] = None
        two_pass = ("" if cs is not None else
                    f", {bound('int8', 0.0, 2 * x_bytes + q_bytes + F * 4)[0]:.3f}"
                    f" ms for the two passes' bytes (the operand read twice)")
        log(f"  op int8 operand quantization ({x_op.shape[0]} x {F} f32 -> {F} x "
            f"{n_op} int8), {key[1]} scales: quantize_int8 {times[key][0]:.3f} ms, "
            f"plain {times[key][1]:.3f} ms, bound {bounds[key][0]:.3f} ms "
            f"({bounds[key][1]}){two_pass}, library none; quantize_per_column "
            f"alone {cuda_ms(lambda: quantize_per_column(x_op, cs), iters=10):.3f}"
            f" ms [{card_line}]")
    q_op = quantize_per_column(x_op, cs_static)[0]
    t_ms = cuda_ms(lambda: transpose_operand(q_op), iters=20)
    t_bound = bound("int8", 0.0, 2.0 * q_op.numel())
    log(f"  op int8 operand transposed copy, the plain version's ({q_op.shape[0]} "
        f"x {F} int8 -> {F} x {q_op.shape[0]}): transpose_operand {t_ms:.3f} ms, "
        f"bound {t_bound[0]:.3f} ms ({t_bound[1]}: each byte read and written "
        f"once) [{card_line}]")
    # the slices' requests under torch.profiler, after every other timing,
    # so that the profiler's own cost touches none of them
    with torch.no_grad():
        for tag, p in slices.items():
            busy, detail = device_profile(lambda: model(p, x0), iters=20)
            if busy is None:
                log(f"  slice GCN request {tag} under torch.profiler: busy share "
                    f"not measured ({detail})")
                continue
            total = sum(detail.values())
            top = "; ".join(f"{name[:70]} {ms:.4f} ms ({ms / total:.1%})"
                            for name, ms in list(detail.items())[:4])
            log(f"  slice GCN request {tag} under torch.profiler: card busy "
                f"{busy:.1%} of the span, {total:.4f} ms of device time a "
                f"request: {top} [{card_line}]")

    t_phase = phase_done("9 timing", t_phase)

    # phase 10, the distributed layer, after every other timing: its ranks
    # share the card, and their counts are read in each rank
    torch.cuda.empty_cache()
    dist_line = dist_phase(op_bsr, x_op, plans[("f32", "sorted")], adj, model,
                           {"f32": slices["f32"], "int8": slices["int8"]}, graphs,
                           card_line)
    t_phase = phase_done("10 dist", t_phase)
    # phase 11, distributed training, after phase 10
    torch.cuda.empty_cache()
    train_dist_line = train_dist_phase(ddi, adj, dims, train["f32"], graphs, card_line)
    t_phase = phase_done("11 train-dist", t_phase)

    # each kernel symbol's entry: the op-shape instance that runs it (K1,
    # K2, K4 and K5 in f32 and bf16, K3 "high" in its three instances,
    # K6-K9 int8 ring alone, with the whole call beside it, K10 at the
    # test_csrmm shape); the tensor-core entries with the F tile width they
    # ran at
    kernels = {}
    for (tag, layout), p in plans.items():
        kid, name, source, replaces = kernel_of(p)
        if name in kernels:
            continue
        key = (tag, layout)
        k_ms, p_ms = times[key]
        kernels[name] = {
            "name": f"{kid} {name}",
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": main_launches[name],
            "max_abs_err": errs[(tag, layout)],
            "ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": bounds[key][0],
            "bound_by": bounds[key][1],
            "library_ms": library[key],
        }
        if tile_bn(name, op_bsr, F):
            kernels[name]["bn"] = tile_bn(name, op_bsr, F)
        if key in whole:
            kernels[name]["whole_call_ms"] = whole[key]
    k_ms, p_ms = times[("split", "split")]
    kernels["split_bf16"] = {
        "name": "K3 split_bf16", "route": "cuda", "source": _F,
        "replaces": KERNEL_INFO[("split",)][3],
        "launches": main_launches["split_bf16"],
        "max_abs_err": errs[("split", "split")], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bounds[("split", "split")][0],
        "bound_by": bounds[("split", "split")][1], "library_ms": None,
    }
    # the quantization: dynamic scales in the standard keys (the ddi
    # slice's), static ones (the op plans') beside them
    (dyn_ms, dyn_plain), (st_ms, st_plain) = (times[("quantize", "dynamic")],
                                              times[("quantize", "static")])
    kernels["quantize_int8"] = {
        "name": "K6-K9 quantize_int8", "route": "cuda", "source": _I8,
        "replaces": KERNEL_INFO[("quantize",)][3],
        "launches": main_launches["quantize_int8"],
        "max_abs_err": errs[("quantize", "quantize")], "ms": dyn_ms,
        "plain_ms": dyn_plain, "bound_ms": bounds[("quantize", "dynamic")][0],
        "bound_by": bounds[("quantize", "dynamic")][1], "library_ms": None,
        "static_ms": st_ms, "static_plain_ms": st_plain,
    }
    t_f32, t_high = times[("f32", "sorted")][0], times[("high", "sorted")][0]
    log(f"[timing] bench.py's headline tier on this card: "
        f"{'f32(bf16x3)' if t_high < t_f32 else 'f32'} (its self-check passed in "
        f"the op phase; high {t_high:.3f} ms, exact f32 {t_f32:.3f} ms) [{card_line}]")
    kernels = sorted(
        [*kernels.values(), *reorder_rows, *serve_rows, *model_rows, *default_rows],
        key=lambda k: (int(re.match(r"K(\d+)", k["name"]).group(1)), k["name"]))
    if {k["name"].split()[0] for k in kernels} != ALL_KERNELS | {"K6-K9"}:
        raise AssertionError(f"kernels line names other than {ALL_KERNELS} and "
                             f"the K6-K9 quantization")
    for tag, err in slice_errs.items():
        log(f"[slice] {tag} SpMMs' largest max |kernel - plain|: {err:.3e}")
    phase_done("12 the kernels line", t_phase)
    total = time.perf_counter() - t_start
    log(f"[done] {total:.1f} s by the script's own clock: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in PHASE_SECONDS.items()))
    print(json.dumps({"dist": dist_line}))
    print(json.dumps({"train_dist": train_dist_line}))
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
