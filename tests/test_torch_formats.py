"""Host-side parity of the PyTorch port with the JAX package: formats,
conversion, datasets, reordering and the normalized adjacency are
bit-equal on the same seeded inputs, and the port never loads jax."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import spmm_denseblock_tpu.convert.csr2bsr as j_conv
import spmm_denseblock_tpu.formats.bsr as j_bsr
import spmm_denseblock_tpu.formats.csr as j_csr
import spmm_denseblock_tpu.io.datasets as j_ds
import spmm_denseblock_tpu.models.graph as j_graph
import spmm_denseblock_tpu.reorder as j_reorder
import spmm_denseblock_tpu_torch.convert.csr2bsr as t_conv
import spmm_denseblock_tpu_torch.formats.bsr as t_bsr
import spmm_denseblock_tpu_torch.formats.csr as t_csr
import spmm_denseblock_tpu_torch.io.datasets as t_ds
import spmm_denseblock_tpu_torch.models.graph as t_graph
import spmm_denseblock_tpu_torch.reorder as t_reorder

torch.set_num_threads(2)


def assert_csr_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.indptr), b.indptr)
    np.testing.assert_array_equal(np.asarray(a.indices), b.indices)
    assert (a.data is None) == (b.data is None)
    if a.data is not None:
        np.testing.assert_array_equal(np.asarray(a.data), b.data)
    assert tuple(a.shape) == tuple(b.shape)


def assert_bsr_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.block_rows), b.block_rows)
    np.testing.assert_array_equal(np.asarray(a.block_cols), b.block_cols)
    np.testing.assert_array_equal(np.asarray(a.blocks), b.blocks)
    assert tuple(a.shape) == tuple(b.shape)
    assert a.block_size == b.block_size and a.nnzb == b.nnzb


@pytest.mark.parametrize("values", ["uniform", "ones"])
def test_random_csr_bit_equal(values):
    a = j_csr.random_csr(0.05, 70, 90, seed=11, values=values)
    b = t_csr.random_csr(0.05, 70, 90, seed=11, values=values)
    assert_csr_equal(a, b)
    assert_csr_equal(a.transpose(), b.transpose())
    np.testing.assert_array_equal(a.degrees(), b.degrees())


@pytest.mark.parametrize("b", [8, 16])
def test_csr_to_bsr_and_transpose_bit_equal(b):
    a = j_csr.random_csr(0.06, 75, 61, seed=3)
    t = t_csr.random_csr(0.06, 75, 61, seed=3)
    ja, tb = j_conv.csr_to_bsr(a, b), t_conv.csr_to_bsr(t, b)
    assert_bsr_equal(ja, tb)
    assert_bsr_equal(ja.transpose(), tb.transpose())
    np.testing.assert_array_equal(ja.block_indptr(), tb.block_indptr())
    np.testing.assert_array_equal(ja.to_dense(), tb.to_dense())
    assert_csr_equal(j_conv.bsr_to_csr(ja), t_conv.bsr_to_csr(tb))
    assert (tb.to_scipy() != ja.to_scipy()).nnz == 0


def test_random_bsr_bit_equal_and_to_device():
    a = j_bsr.random_bsr(0.2, 9, 7, block_size=8, seed=5)
    b = t_bsr.random_bsr(0.2, 9, 7, block_size=8, seed=5)
    assert_bsr_equal(a, b)
    on = b.to("cpu", torch.bfloat16)
    assert on["blocks"].dtype == torch.bfloat16
    assert on["block_rows"].dtype == torch.int32
    np.testing.assert_array_equal(on["block_cols"].numpy(), b.block_cols)
    c = t_csr.random_csr(0.1, 20, seed=1).to("cpu")
    assert c["indptr"].shape == (21,) and c["data"].dtype == torch.float32


def test_sym_norm_adjacency_bit_equal():
    a = j_csr.random_csr(0.05, 120, seed=2, values="ones")
    b = t_csr.random_csr(0.05, 120, seed=2, values="ones")
    assert_csr_equal(j_graph.sym_norm_adjacency(a), t_graph.sym_norm_adjacency(b))
    assert_csr_equal(j_graph.mean_adjacency(a), t_graph.mean_adjacency(b))
    assert_csr_equal(j_graph.add_self_loops(a), t_graph.add_self_loops(b))


@pytest.mark.parametrize("profile", ["legacy", "calibrated"])
def test_load_dataset_bit_equal(tmp_path, profile):
    a = j_ds.load_dataset("ogbl-ddi", cache_dir=str(tmp_path / "jax"),
                          scale=0.05, profile=profile)
    b = t_ds.load_dataset("ogbl-ddi", cache_dir=str(tmp_path / "torch"),
                          scale=0.05, profile=profile)
    assert_csr_equal(a, b)
    # a second load reads the cache and returns the same graph
    assert_csr_equal(b, t_ds.load_dataset("ogbl-ddi", cache_dir=str(tmp_path / "torch"),
                                          scale=0.05, profile=profile))


@pytest.mark.parametrize("strategy", ["original", "degree", "bfs", "rcmk", "rcm",
                                      "gorder", "rabbit", "closest",
                                      "gpmetis_rcmk", "ndmetis"])
def test_reorder_bit_equal(strategy, tmp_path):
    assert list(t_reorder.STRATEGIES) == list(j_reorder.STRATEGIES)
    a = j_ds.load_dataset("ogbl-ddi", cache_dir=str(tmp_path), scale=0.03)
    b = t_ds.load_dataset("ogbl-ddi", cache_dir=str(tmp_path), scale=0.03)
    ra, pa = j_reorder.reorder(a, strategy)
    rb, pb = t_reorder.reorder(b, strategy)
    np.testing.assert_array_equal(pa, pb)
    assert_csr_equal(ra, rb)
    # the cached variant writes the permutation once and reuses it
    rc, pc = t_reorder.reorder_cached(b, strategy, cache_dir=str(tmp_path), tag="g")
    rc2, pc2 = t_reorder.reorder_cached(b, strategy, cache_dir=str(tmp_path), tag="g")
    np.testing.assert_array_equal(pc, pb)
    np.testing.assert_array_equal(pc2, pb)
    assert_csr_equal(rc2, rb)


def test_port_never_imports_jax():
    """Importing the port and running a CPU plan through it leaves jax out
    of sys.modules (the JAX package's __init__ imports jax)."""
    code = (
        "import sys, torch\n"
        "import spmm_denseblock_tpu_torch as P\n"
        "from spmm_denseblock_tpu_torch.formats import random_csr\n"
        "from spmm_denseblock_tpu_torch.models import sym_norm_adjacency, GCN\n"
        "from spmm_denseblock_tpu_torch.ops import spmm_plan\n"
        "from spmm_denseblock_tpu_torch.reorder import reorder\n"
        "from spmm_denseblock_tpu_torch.io import load_dataset\n"
        "import spmm_denseblock_tpu_torch.ops._kernels\n"
        "adj = sym_norm_adjacency(reorder(random_csr(0.05, 64, seed=0), 'rcmk')[0])\n"
        "import spmm_denseblock_tpu_torch.ops.csr_spmm\n"
        "import spmm_denseblock_tpu_torch.ops.csr_spmm_pallas\n"
        "import spmm_denseblock_tpu_torch.ops._device\n"
        "import spmm_denseblock_tpu_torch.entry\n"
        "import spmm_denseblock_tpu_torch.native\n"
        "import spmm_denseblock_tpu_torch.analyze\n"
        "import spmm_denseblock_tpu_torch.reorder.__main__\n"
        "from spmm_denseblock_tpu_torch.reorder import gorder, rabbit_order, \\\n"
        "    greedy_closest, metis_partition_rcm, nested_dissection\n"
        "from spmm_denseblock_tpu_torch.analyze import block_metrics\n"
        "g = random_csr(0.05, 64, seed=0)\n"
        "assert block_metrics(reorder(g, 'rabbit')[0], [16])[16]['nnzb'] > 0\n"
        "for impl in ('bsr_pallas', 'csr_pallas', 'csr_xla', 'bcoo'):\n"
        "    plan = spmm_plan(adj, impl=impl, block_size=16, grad=False, device='cpu')\n"
        "    out = GCN([8, 4])(plan, torch.ones(64, 8))\n"
        "    assert out.shape == (64, 4)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'spmm_denseblock_tpu' or m.startswith('spmm_denseblock_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
