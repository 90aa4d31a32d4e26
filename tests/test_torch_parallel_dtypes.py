"""Distributed BSR SpMM of the port in every dtype and on every stripe
layout, held to the JAX package's plans: local_impl="pallas" through the
stripe routers' plain versions (flat, depth-sorted and row-group
layouts, grouped, ragged, ring and halo buckets), bf16 (K2's and K4's
layouts), precision="high" (K3's), int8 in both local impls with and
without calibration (per-slot and group-scale layouts, halo, the
contiguous-balanced halo, the (2, 2) mesh, where the column absmax is
reduced over the row group only), and the contract errors. int8 cases
assert the layout tag first: it decides int8's answer. One world of 4
CPU ranks over gloo runs every case (module fixture)."""

import numpy as np
import pytest
import torch

from spmm_denseblock_tpu.formats.bsr import random_bsr
from test_torch_parallel_bsr import banded, graded_band
from torch_parallel_cases import port_bsr, world_results
from torch_parallel_jax import check

torch.set_num_threads(1)


def _x(n_rows, f, seed):
    return np.random.default_rng(seed).standard_normal((n_rows, f)).astype(np.float32)


def _case(name, jb, f, seed, mesh="1d", raises=None, **kw):
    c = {"name": name, "kind": "bsr", "jmat": jb, "mat": port_bsr(jb),
         "x": _x(jb.shape[1], f, seed), "kw": kw, "mesh": mesh}
    if raises:
        c["raises"] = raises
    return c


def _cases():
    rnd = random_bsr(0.15, 16, 16, block_size=8, seed=7)      # 2.4 blocks a row
    ragged = random_bsr(0.08, 13, 11, block_size=8, seed=3)
    deep = random_bsr(0.6, 16, 16, block_size=8, seed=21)     # >= 8: sorted
    thin = random_bsr(0.08, 16, 16, block_size=8, seed=22)    # < 2: row groups
    cal = _x(400, 16, 99)
    out = []
    for s in ("allgather", "ring"):
        P = {"strategy": s, "local_impl": "pallas"}
        out += [
            _case(f"{s}_pallas_flat", rnd, 16, 1, **P),
            _case(f"{s}_pallas_flat_ragged_g4", ragged, 10, 2, group=4, **P),
            _case(f"{s}_pallas_sorted_f32", deep, 16, 3, **P),
            _case(f"{s}_pallas_f32_no_depth_sort", deep, 16, 3, depth_sort=False, **P),
            _case(f"{s}_pallas_high_sorted", deep, 16, 4, precision="high", **P),
            _case(f"{s}_pallas_high_flat", rnd, 16, 4, precision="high", **P),
            _case(f"{s}_bf16_xla", rnd, 16, 5, strategy=s, dtype="bfloat16"),
            _case(f"{s}_pallas_bf16_sorted", rnd, 16, 5, dtype="bfloat16", **P),
            _case(f"{s}_pallas_bf16_rowgroup", thin, 16, 6, dtype="bfloat16", **P),
            _case(f"{s}_pallas_bf16_no_depth_sort", rnd, 16, 6, dtype="bfloat16",
                  depth_sort=False, **P),
            _case(f"{s}_pallas_bf16_high", deep, 16, 6, dtype="bfloat16",
                  precision="high", **P),
            _case(f"{s}_int8_xla", rnd, 16, 7, strategy=s, dtype="int8"),
            _case(f"{s}_int8_xla_calibrated", rnd, 16, 7, strategy=s, dtype="int8",
                  calibration=cal),
            _case(f"{s}_pallas_int8_rowgroup_g2", rnd, 16, 8, dtype="int8", group=2, **P),
            _case(f"{s}_pallas_int8_rowgroup_calibrated", rnd, 16, 8, dtype="int8",
                  group=2, calibration=cal, **P),
            _case(f"{s}_pallas_int8_sorted_gs", deep, 16, 9, dtype="int8", **P),
            _case(f"{s}_pallas_int8_sorted_per_slot", deep, 16, 9, dtype="int8",
                  group_scale=False, **P),
            _case(f"{s}_pallas_int8_sorted_gs_calibrated", deep, 16, 9, dtype="int8",
                  calibration=cal, **P),
            _case(f"{s}_pallas_int8_2d", deep, 16, 10, mesh="2d", dtype="int8",
                  feature_axis="col", **P),
            _case(f"{s}_int8_xla_2d", rnd, 16, 10, mesh="2d", strategy=s,
                  dtype="int8", feature_axis="col"),
            _case(f"{s}_pallas_bf16_2d", deep, 16, 11, mesh="2d", dtype="bfloat16",
                  feature_axis="col", **P),
        ]
    out += [
        _case("allgather_pallas_grouped_g4", rnd, 24, 12, strategy="allgather",
              local_impl="pallas", group=4),
        _case("halo_pallas_flat", banded(), 12, 13, strategy="halo", local_impl="pallas"),
        _case("halo_pallas_bf16", banded(), 12, 13, strategy="halo",
              local_impl="pallas", dtype="bfloat16"),
        _case("halo_int8_xla", banded(), 12, 14, strategy="halo", dtype="int8"),
        _case("halo_pallas_int8", banded(), 12, 14, strategy="halo", dtype="int8",
              local_impl="pallas"),
        _case("contiguous_halo_int8", graded_band((8, 2)), 12, 15, strategy="halo",
              balance="contiguous", dtype="int8"),
        _case("contiguous_halo_pallas_int8", graded_band((8, 2)), 12, 15,
              strategy="halo", balance="contiguous", dtype="int8", local_impl="pallas"),
        _case("rejects_mismatched_calibration", rnd, 16, 16, raises="ValueError",
              calibration=_x(10, 16, 16)),
        _case("rejects_precision_without_pallas", rnd, 16, 16, raises="ValueError",
              precision="high"),
    ]
    return out


CASES = {c["name"]: c for c in _cases()}


@pytest.fixture(scope="module")
def results():
    return world_results([{k: v for k, v in c.items() if k != "jmat"}
                          for c in CASES.values()])


@pytest.mark.parametrize("name", list(CASES))
def test_dist_bsr_dtypes_match_jax(results, name):
    check(results, CASES[name])
