"""The last two public names of the JAX package that the port lacked:
io/datasets.DATASET_PUBLISHED (the OGB-published clustering the synthetic
stand-ins are calibrated to) and convert/csr2bsr.csr_to_bsr_pruned. The
calibration test mirrors tests/test_analyze_io.py's
test_lattice_knob_and_calibrated_profiles on the port's generator, at the
same scaled sizes and with its bounds."""

import numpy as np
import pytest

import spmm_denseblock_tpu.convert.csr2bsr as j_convert
import spmm_denseblock_tpu.formats.csr as j_csr
import spmm_denseblock_tpu.io.datasets as j_datasets
from spmm_denseblock_tpu_torch.convert.csr2bsr import csr_to_bsr, csr_to_bsr_pruned
from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.io import (
    DATASET_PROFILES,
    DATASET_PUBLISHED,
    DATASET_SIZES,
    graph_stats,
    synthetic_powerlaw,
)


def test_dataset_published_is_jax_s():
    assert DATASET_PUBLISHED == j_datasets.DATASET_PUBLISHED
    assert set(DATASET_PUBLISHED) == set(DATASET_SIZES)


def test_lattice_knob_raises_clustering():
    cc = [graph_stats(synthetic_powerlaw(8000, 160000, lattice=lat), sample=300,
                      seed=1)["clustering_sampled"]
          for lat in (0.0, 0.5, 0.9)]
    assert cc[0] < cc[1] < cc[2]
    assert cc[2] > 0.45


@pytest.mark.parametrize("name,scale", [("ogbn-arxiv", 0.05), ("ogbl-ddi", 0.5)])
def test_calibrated_profiles_beat_legacy(name, scale):
    """At the JAX test's scaled sizes the calibrated profile's sampled
    clustering lands nearer DATASET_PUBLISHED's than the legacy
    generator's, and within 0.12 of it."""
    knobs = {k: v for k, v in DATASET_PROFILES[name].items() if not k.startswith("_")}
    target = DATASET_PUBLISHED[name]["clustering"]
    n, nnz = (int(v * scale) for v in DATASET_SIZES[name])
    legacy = graph_stats(synthetic_powerlaw(n, nnz), sample=300, seed=1)
    cal = graph_stats(synthetic_powerlaw(n, nnz, **knobs), sample=300, seed=1)
    err_legacy = abs(legacy["clustering_sampled"] - target)
    err_cal = abs(cal["clustering_sampled"] - target)
    assert err_cal < err_legacy, (name, legacy, cal, target)
    assert err_cal < 0.12, (name, cal, target)


@pytest.mark.parametrize("b", [4, 16])
def test_csr_to_bsr_pruned(b):
    """csr_to_bsr_pruned is csr_to_bsr, and JAX's, bit for bit (explicit
    zeros in the CSR included: a block of them is kept by both)."""
    rng = np.random.default_rng(b)
    rows, cols = rng.integers(0, 50, 400), rng.integers(0, 37, 400)
    vals = rng.standard_normal(400).astype(np.float32)
    vals[::7] = 0.0
    got = csr_to_bsr_pruned(CSR.from_coo(rows, cols, vals, (50, 37)), b)
    same = csr_to_bsr(CSR.from_coo(rows, cols, vals, (50, 37)), b)
    want = j_convert.csr_to_bsr_pruned(j_csr.CSR.from_coo(rows, cols, vals, (50, 37)), b)
    assert got.shape == same.shape == tuple(want.shape)
    for name in ("block_rows", "block_cols", "blocks"):
        a = np.asarray(getattr(got, name))[: got.nnzb]
        np.testing.assert_array_equal(a, np.asarray(getattr(same, name))[: same.nnzb])
        np.testing.assert_array_equal(a, np.asarray(getattr(want, name))[: want.nnzb])
