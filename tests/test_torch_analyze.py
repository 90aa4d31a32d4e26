"""The port's block analytics, packing helpers, graph file I/O and reorder
CLI against the JAX package's: the metrics, histograms, profiles,
heatmaps, repacked blocks and the molecule study are bit-equal, the files
byte-equal, and the two CLIs write the same files and print the same
metric lines on the same edge list."""

import filecmp
import os
import re

import numpy as np
import pytest
import torch

import spmm_denseblock_tpu.analyze as j_an
import spmm_denseblock_tpu.convert as j_conv
import spmm_denseblock_tpu.formats.bsr as j_bsr
import spmm_denseblock_tpu.formats.csr as j_csr
import spmm_denseblock_tpu.io.graph_io as j_io
import spmm_denseblock_tpu.io.datasets as j_ds
import spmm_denseblock_tpu.reorder.__main__ as j_cli
import spmm_denseblock_tpu_torch.analyze as t_an
import spmm_denseblock_tpu_torch.convert as t_conv
import spmm_denseblock_tpu_torch.formats.bsr as t_bsr
import spmm_denseblock_tpu_torch.formats.csr as t_csr
import spmm_denseblock_tpu_torch.io as t_io
import spmm_denseblock_tpu_torch.io.datasets as t_ds
import spmm_denseblock_tpu_torch.reorder.__main__ as t_cli
from test_torch_formats import assert_csr_equal

torch.set_num_threads(2)


def pair(p=0.05, n=120, m=None, seed=2, values="uniform"):
    return (j_csr.random_csr(p, n, m, seed=seed, values=values),
            t_csr.random_csr(p, n, m, seed=seed, values=values))


@pytest.mark.parametrize("shape", [(120, None), (90, 61)])
def test_block_metrics_bit_equal(shape):
    a, b = pair(0.05, *shape, seed=3)
    assert j_an.block_metrics(a) == t_an.block_metrics(b)
    assert t_an.DEFAULT_BLOCK_SIZES == j_an.DEFAULT_BLOCK_SIZES
    for bs in (2, 8, 32):
        assert t_an.calculate_nnzb(b, bs) == j_an.calculate_nnzb(a, bs)
        np.testing.assert_array_equal(t_an.fill_histogram(b, bs),
                                      j_an.fill_histogram(a, bs))
        np.testing.assert_array_equal(t_an.fill_histogram(b, bs, n_buckets=4),
                                      j_an.fill_histogram(a, bs, n_buckets=4))
    assert t_an.bandwidth_profile(b) == j_an.bandwidth_profile(a)
    empty = t_csr.CSR(np.zeros(5, np.int32), np.zeros(0, np.int32), None, (4, 4))
    assert t_an.bandwidth_profile(empty)["bandwidth"] == 0.0


@pytest.mark.parametrize("compact_slots", [1 << 20, 64])
@pytest.mark.parametrize("bucket,feat_dim,itemsize", [
    ("quarter", 128, 4), ("pow2", 128, 4), ("quarter", 1 << 16, 4),
    ("quarter", 1 << 16, 2)])
def test_ell_metrics_bit_equal(bucket, feat_dim, itemsize, compact_slots,
                               monkeypatch):
    """ell_metrics with the compaction model: every field the port keeps
    (slots, padded_ratio, classes, chunks, table_bytes, U/S, compacted
    spans) equals JAX's; the JAX fields it leaves out are the time
    estimates at TPU v5e rates. COMPACT_SLOTS at 64 gives many spans,
    and at feat_dim 2^16 (a 524 MB f32 table) the model compacts some
    of them."""
    import importlib

    for mod in ("spmm_denseblock_tpu.ops.csr_spmm_ell",
                "spmm_denseblock_tpu_torch.ops.csr_spmm_ell"):
        monkeypatch.setattr(importlib.import_module(mod), "COMPACT_SLOTS", compact_slots)
    # rows whose neighbours lie in a window that moves with the row: a
    # span's unique neighbours are far fewer than its slots
    rng = np.random.default_rng(9)
    rows = np.repeat(np.arange(400), rng.integers(1, 12, 400))
    key = np.unique(rows * 2000 + (rows * 5 + rng.integers(0, 24, rows.size)) % 2000)
    parts = (key // 2000, key % 2000, None, (400, 2000))
    a, b = j_csr.CSR.from_coo(*parts), t_csr.CSR.from_coo(*parts)
    want = j_an.ell_metrics(a, bucket, feat_dim, itemsize, compact_model=True)
    got = t_an.ell_metrics(b, bucket, feat_dim, itemsize, compact_model=True)
    assert got == {k: v for k, v in want.items() if not k.startswith("est_ms")}
    assert set(want) - set(got) == {"est_ms_small_table_rate", "est_ms_big_table_rate",
                                    "est_ms_flat", "est_ms_two_level"}
    assert t_an.ell_compact_metrics(b, bucket, feat_dim, itemsize) == {
        k: want[k] for k in ("compact_u_over_s", "compact_spans")}
    if (feat_dim, itemsize, compact_slots) == (1 << 16, 4, 64):
        assert got["compact_spans"] > 0


def test_heatmap_dump_load_bit_equal(tmp_path):
    a, b = pair(0.05, 300, seed=4)
    ha, hb = j_an.heatmap(a, 64), t_an.heatmap(b, 64)
    np.testing.assert_array_equal(ha, hb)
    j_an.dump_heatmap(ha, tmp_path / "j.txt")
    t_an.dump_heatmap(hb, tmp_path / "t.txt")
    assert filecmp.cmp(tmp_path / "j.txt", tmp_path / "t.txt", shallow=False)
    np.testing.assert_array_equal(t_an.load_heatmap(tmp_path / "t.txt"), hb)


@pytest.mark.parametrize("b,nb", [(8, 32), (16, 64), (16, 16)])
def test_repack_bsr_bit_equal(b, nb):
    a = j_bsr.random_bsr(0.2, 9, 7, block_size=b, seed=5)
    t = t_bsr.random_bsr(0.2, 9, 7, block_size=b, seed=5)
    ra, rt = j_conv.repack_bsr(a, nb), t_conv.repack_bsr(t, nb)
    np.testing.assert_array_equal(np.asarray(ra.block_rows), rt.block_rows)
    np.testing.assert_array_equal(np.asarray(ra.block_cols), rt.block_cols)
    np.testing.assert_array_equal(np.asarray(ra.blocks), rt.blocks)
    assert rt.b == nb and rt.shape == t.shape
    np.testing.assert_array_equal(rt.to_dense(), t.to_dense())
    with pytest.raises(ValueError, match="multiple"):
        t_conv.repack_bsr(t, b + 1)


def test_pad_dense_rows_bit_equal():
    x = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    for n in (5, 8):
        np.testing.assert_array_equal(t_conv.pad_dense_rows(x, n),
                                      j_conv.pad_dense_rows(x, n))
    assert t_conv.round_up(17, 8) == j_conv.round_up(17, 8) == 24


def test_molecules_bit_equal():
    """synthetic_molecules, per_graph_reorder and the 100-graph
    utilization study."""
    a, ga = j_ds.synthetic_molecules(n_graphs=40, mean_nodes=12, seed=9)
    b, gb = t_ds.synthetic_molecules(n_graphs=40, mean_nodes=12, seed=9)
    assert_csr_equal(a, b)
    np.testing.assert_array_equal(ga, gb)
    for strategy in ("rcmk", "closest"):
        np.testing.assert_array_equal(
            t_an.per_graph_reorder(b, gb, strategy),
            j_an.per_graph_reorder(a, ga, strategy))
    assert (t_an.molecule_utilization_study(b, gb, n_graphs=30)
            == j_an.molecule_utilization_study(a, ga, n_graphs=30))
    with pytest.raises(ValueError, match="graph_ids"):
        t_an.per_graph_reorder(b, gb[:-1])


def test_graph_stats_and_provenance_bit_equal():
    a = j_ds.synthetic_powerlaw(500, 6000, seed=2)
    b = t_ds.synthetic_powerlaw(500, 6000, seed=2)
    assert t_ds.graph_stats(b, sample=200) == j_ds.graph_stats(a, sample=200)
    assert t_ds.dataset_provenance("ogbn-arxiv") == j_ds.dataset_provenance("ogbn-arxiv")
    assert t_ds.list_datasets() == j_ds.list_datasets()


def test_graph_files_byte_equal_and_round_trip(tmp_path):
    """dump_csr, dump_edge_list and dump_metis_graph write the JAX
    package's bytes; load_csr and load_edge_list read them back."""
    a = j_ds.synthetic_powerlaw(200, 1600, seed=6)
    b = t_ds.synthetic_powerlaw(200, 1600, seed=6)
    j_io.dump_csr(a, str(tmp_path / "j"))
    t_io.dump_csr(b, str(tmp_path / "t"))
    for part in ("_indptr.txt", "_indices.txt"):
        assert filecmp.cmp(tmp_path / f"j{part}", tmp_path / f"t{part}", shallow=False)
    assert_csr_equal(b, t_io.load_csr(str(tmp_path / "t")))
    j_io.dump_edge_list(a, str(tmp_path / "j.el"))
    t_io.dump_edge_list(b, str(tmp_path / "t.el"))
    assert filecmp.cmp(tmp_path / "j.el", tmp_path / "t.el", shallow=False)
    assert_csr_equal(b, t_io.load_edge_list(str(tmp_path / "t.el")))
    j_io.dump_metis_graph(a, str(tmp_path / "j.graph"))
    t_io.dump_metis_graph(b, str(tmp_path / "t.graph"))
    assert filecmp.cmp(tmp_path / "j.graph", tmp_path / "t.graph", shallow=False)
    with open(tmp_path / "bad.el", "w") as f:
        f.write("4 3\n0 1\n1 0\n")
    with pytest.raises(ValueError, match="expected 3 edges"):
        t_io.load_edge_list(str(tmp_path / "bad.el"))


def _metric_lines(text: str) -> list:
    """The CLI's lines less the timing line and the JAX CLI's ELL model."""
    return [line for line in text.splitlines()
            if not line.startswith("  ell") and not re.fullmatch(r"\w+: [0-9.]+s", line)]


def _ell_lines(text: str) -> list:
    """The CLI's ELL lines, cut before the JAX CLI's time estimates."""
    return [re.split(r" est=| modeled ", line)[0] for line in text.splitlines()
            if line.startswith("  ell")]


@pytest.mark.parametrize("strategy", ["rcmk", "rabbit"])
def test_cli_matches_jax_cli(strategy, tmp_path, capsys):
    """Both CLIs on one edge list, into two directories: the same files
    (the heatmap images aside, each byte-equal) and the same metric
    lines; the ELL lines, with --ell-compact too, are the JAX CLI's
    without their time estimates at TPU v5e rates."""
    g = t_ds.synthetic_powerlaw(400, 4000, seed=8)
    edges = tmp_path / "g.txt"
    t_io.dump_edge_list(g, str(edges))
    argv = [str(edges), strategy, "--block-sizes", "8", "32", "--heatmap",
            "--heatmap-block", "64"]
    assert j_cli.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    j_out = capsys.readouterr().out
    assert t_cli.main(argv + ["--out", str(tmp_path / "torch")]) == 0
    t_out = capsys.readouterr().out
    assert _metric_lines(t_out) == _metric_lines(j_out)
    assert "  b=  32: nnzb=" in t_out and f"-- {strategy} --" in t_out
    j_files = sorted(os.listdir(tmp_path / "jax"))
    assert j_files == sorted(os.listdir(tmp_path / "torch"))
    assert f"g_{strategy}.txt" in j_files and "g_original_heatmap.txt" in j_files
    for name in j_files:
        if not name.endswith(".png"):
            assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "torch" / name,
                               shallow=False), name
    assert j_cli.main(argv + ["--ell-compact", "--out", str(tmp_path / "j2")]) == 0
    j_ell = _ell_lines(capsys.readouterr().out)
    assert t_cli.main(argv + ["--ell-compact", "--out", str(tmp_path / "t2")]) == 0
    assert _ell_lines(capsys.readouterr().out) == j_ell
    assert len(j_ell) == 4 and j_ell[1].startswith("  ell compact: U/S=")
    assert t_cli.main([str(edges), "no-such-strategy"]) == 2
