"""Distributed BSR SpMM strategies of the port (parallel/spmm.py) held to
the JAX package's plans: allgather, ring and halo, with ragged shapes and
from a graph CSR, strategy "auto", LPT and contiguous balancing, and the
(2, 2) mesh with the feature axis; the xla local impl, plus the pallas
one on the 2D mesh. One world of 4 CPU ranks over gloo runs every case
(module fixture); each case's test compares the gathered C with JAX's on
the same mesh size (tests/torch_parallel_jax.py)."""

import numpy as np
import pytest
import torch

from spmm_denseblock_tpu.convert.csr2bsr import csr_to_bsr
from spmm_denseblock_tpu.formats.bsr import BSR, random_bsr
from spmm_denseblock_tpu.formats.csr import CSR, random_csr
from torch_parallel_cases import port_bsr, world_results
from torch_parallel_jax import check

torch.set_num_threads(1)


def _x(n_rows, f, seed):
    return np.random.default_rng(seed).standard_normal((n_rows, f)).astype(np.float32)


def banded(width=5, lo=-16):
    n = 32 * 8
    rows = np.repeat(np.arange(n), width)
    cols = (rows + np.tile(np.arange(lo, lo + width), n)) % n
    return csr_to_bsr(CSR.from_coo(rows, cols, None, (n, n)), 8)


def graded_band(levels=(8, 4, 2)):
    """A banded adjacency whose density falls from the first rows to the
    last: contiguous uniform stripes are imbalanced, the band narrow."""
    n = 64 * 8
    rows_l, cols_l = [], []
    for r in range(n):
        k = levels[min(len(levels) - 1, r * len(levels) // n)]
        for j in range(k):
            rows_l.append(r)
            cols_l.append(min(n - 1, max(0, r - 4 + j)))
    return csr_to_bsr(CSR.from_coo(np.array(rows_l), np.array(cols_l), None, (n, n)), 8)


def hub_bsr():
    """All blocks on the first two block-rows: contiguous stripes are
    maximally imbalanced."""
    b, nbr, nbc = 8, 16, 12
    rows = np.repeat(np.array([0, 1], dtype=np.int32), 12)
    cols = np.tile(np.arange(12, dtype=np.int32), 2)
    blocks = np.random.default_rng(5).standard_normal((24, b, b)).astype(np.float32)
    return BSR.from_parts(rows, cols, blocks, (nbr * b - 3, nbc * b - 5), b)


def _case(name, jb, f, seed, **kw):
    mesh = "2d" if kw.get("feature_axis") else "1d"
    return {"name": name, "kind": "bsr", "jmat": jb, "mat": port_bsr(jb),
            "x": _x(jb.shape[1], f, seed), "kw": kw, "mesh": mesh}


def _cases():
    rnd = random_bsr(0.15, 16, 16, block_size=8, seed=7)
    ragged = random_bsr(0.2, 13, 11, block_size=8, seed=3)
    graph = csr_to_bsr(random_csr(0.02, 400, 384, seed=11, values="ones"), 16)
    band, hub, graded = banded(), hub_bsr(), graded_band()
    scattered = random_bsr(0.15, 16, 16, block_size=8, seed=9)
    out = []
    for s in ("allgather", "ring"):
        out += [
            _case(f"{s}_random", rnd, 24, 1, strategy=s),
            _case(f"{s}_ragged", ragged, 10, 2, strategy=s),
            _case(f"{s}_graph_csr", graph, 32, 3, strategy=s),
            _case(f"{s}_lpt_auto", hub, 10, 4, strategy=s, balance="auto"),
            _case(f"{s}_lpt_forced", hub, 10, 4, strategy=s, balance=True),
            _case(f"{s}_2d_feature_axis", rnd, 16, 5, strategy=s, feature_axis="col"),
            _case(f"{s}_2d_feature_axis_pallas", rnd, 16, 5, strategy=s,
                  feature_axis="col", local_impl="pallas"),
            _case(f"{s}_2d_feature_axis_ragged_f", rnd, 15, 6, strategy=s,
                  feature_axis="col", local_impl="pallas"),
        ]
        for shape_name, nbr, nbc in (("rect_wide", 9, 21), ("rect_tall", 21, 9),
                                     ("tiny", 2, 3)):
            jb = random_bsr(0.3, nbr, nbc, block_size=8, seed=nbr * 31 + nbc)
            out.append(_case(f"{s}_{shape_name}", jb, 10, 7, strategy=s))
    out += [
        _case("halo_banded", band, 12, 8, strategy="halo"),
        _case("halo_scattered_falls_back", scattered, 10, 9, strategy="halo"),
        _case("halo_wide_band_two", banded(9, -20), 12, 8, strategy="halo", halo=2,
              balance=False),
        _case("auto_banded", banded(3, 0), 8, 10, strategy="auto"),
        _case("auto_scattered", random_bsr(0.2, 16, 16, block_size=8, seed=4), 8, 11,
              strategy="auto"),
        _case("contiguous_halo", graded, 12, 12, strategy="halo", balance="contiguous"),
        _case("contiguous_halo_auto_balance", graded, 12, 12, strategy="halo"),
        _case("contiguous_auto_strategy", graded, 12, 12, strategy="auto"),
        _case("ring_no_balance_hub", hub, 10, 4, strategy="ring", balance=False),
    ]
    return out


CASES = {c["name"]: c for c in _cases()}


@pytest.fixture(scope="module")
def results():
    return world_results([{k: v for k, v in c.items() if k != "jmat"}
                          for c in CASES.values()])


@pytest.mark.parametrize("name", list(CASES))
def test_dist_bsr_matches_jax(results, name):
    check(results, CASES[name])
