"""The port's reorder engine against the JAX package's: every strategy of
STRATEGIES on the native path equals the JAX package's native one, and on
the plain path (impl="python") JAX's SDB_NO_NATIVE=1 path, bit for bit;
inside the port the native engine equals its plain version (rabbit: a
valid permutation of comparable block density, as the JAX package
checks); the JAX package's SDB_GORDER_FLOOR / SDB_RABBIT_CAP knobs are
arguments here; permutate, reorder_per_component and the METIS adapters
match; a failed build of the engine raises."""

import sys

import numpy as np
import pytest
import torch

import spmm_denseblock_tpu.formats.csr as j_csr
import spmm_denseblock_tpu.io.datasets as j_ds
import spmm_denseblock_tpu.native as j_native
import spmm_denseblock_tpu.reorder as j_reorder
import spmm_denseblock_tpu_torch.formats.csr as t_csr
import spmm_denseblock_tpu_torch.native as t_native
import spmm_denseblock_tpu_torch.reorder as t_reorder
from spmm_denseblock_tpu_torch.analyze.metrics import block_metrics
from test_torch_formats import assert_csr_equal

torch.set_num_threads(2)

# the strategies with a native body in both packages
NATIVE = ("degree", "bfs", "rcmk", "gorder", "rabbit", "closest")


def to_port(a):
    """The port's CSR holding a JAX package CSR's arrays."""
    return t_csr.CSR(
        indptr=np.asarray(a.indptr, np.int32),
        indices=np.asarray(a.indices, np.int32),
        data=None if a.data is None else np.asarray(a.data, np.float32),
        shape=tuple(a.shape),
    )


# the graphs of the JAX package's tests/test_native.py, and ddi at 3%
GRAPHS = {
    "random": lambda tmp: j_csr.random_csr(0.05, 80, seed=3, values="ones"),
    "powerlaw": lambda tmp: j_ds.synthetic_powerlaw(300, 3000, seed=5),
    "pairs": lambda tmp: j_csr.CSR.from_edges(
        np.array([[0, 1], [1, 0], [2, 3], [3, 2]]), 6),
    "ddi": lambda tmp: j_ds.load_dataset("ogbl-ddi", cache_dir=str(tmp), scale=0.03),
}


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """{name: (JAX CSR, port CSR)}; both engines built."""
    assert j_native.load() is not None, "the JAX package's engine did not build"
    t_native.load()
    tmp = tmp_path_factory.mktemp("ddi")
    out = {}
    for name, make in GRAPHS.items():
        a = make(tmp)
        out[name] = (a, to_port(a))
    return out


def run_port(name, csr, impl):
    fn = t_reorder.STRATEGIES[name]
    kw = {"impl": impl} if name in NATIVE + ("gpmetis_rcmk",) else {}
    return fn(csr, **kw)


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("name", sorted(j_reorder.STRATEGIES))
def test_native_path_bit_equal_to_jax(graphs, name, graph, monkeypatch):
    """The default (native) path of every strategy, and reorder's
    permutate through sdb_permutate, against the JAX package's."""
    monkeypatch.delenv("SDB_NO_NATIVE", raising=False)
    a, b = graphs[graph]
    ra, pa = j_reorder.reorder(a, name)
    rb, pb = t_reorder.reorder(b, name)
    t_reorder.check_permutation(pb, b.n_rows)
    assert pb.dtype == np.int64
    np.testing.assert_array_equal(pa, pb)
    assert_csr_equal(ra, rb)


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("name", sorted(j_reorder.STRATEGIES))
def test_plain_path_bit_equal_to_jax(graphs, name, graph, monkeypatch):
    """impl="python" (and the numpy permutate) against the JAX package
    with SDB_NO_NATIVE=1."""
    monkeypatch.setenv("SDB_NO_NATIVE", "1")
    a, b = graphs[graph]
    ra, pa = j_reorder.reorder(a, name)
    pb = run_port(name, b, "python")
    np.testing.assert_array_equal(pa, pb)
    assert_csr_equal(ra, t_reorder.permutate(pb, b, impl="python"))


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("name", NATIVE)
def test_native_matches_plain_in_the_port(graphs, name, graph):
    b = graphs[graph][1]
    got = run_port(name, b, "native")
    want = run_port(name, b, "python")
    t_reorder.check_permutation(got, b.n_rows)
    if name != "rabbit":
        np.testing.assert_array_equal(got, want)
        return
    # rabbit's ties between equal gains may break differently: the same
    # clustering quality, as the JAX package's tests hold it
    d_native = block_metrics(t_reorder.permutate(got, b), [16])[16]["density"]
    d_python = block_metrics(t_reorder.permutate(want, b), [16])[16]["density"]
    assert d_native <= d_python * 1.3 + 1e-9


@pytest.mark.parametrize("impl", ["native", "python"])
def test_gorder_floor_is_an_argument(graphs, impl, monkeypatch):
    """gorder(floor=8) equals the JAX package's gorder under
    SDB_GORDER_FLOOR=8, on each path."""
    monkeypatch.setenv("SDB_GORDER_FLOOR", "8")
    if impl == "python":
        monkeypatch.setenv("SDB_NO_NATIVE", "1")
    a = j_ds.synthetic_powerlaw(4096, 4096 * 16, seed=7) if impl == "native" \
        else graphs["powerlaw"][0]
    want = j_reorder.gorder(a)
    got = t_reorder.gorder(to_port(a), floor=8, impl=impl)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cap", [0, 1, 4])
def test_rabbit_cap_is_an_argument(cap, monkeypatch):
    """rabbit_order(cap=c) equals the JAX package's native rabbit under
    SDB_RABBIT_CAP=c (0: unlimited), and a cap of 1 changes the order
    of a hub-rich graph, so the argument reaches the engine."""
    monkeypatch.delenv("SDB_NO_NATIVE", raising=False)
    a = j_ds.synthetic_powerlaw(2000, 40_000, seed=11)
    b = to_port(a)
    monkeypatch.setenv("SDB_RABBIT_CAP", str(cap))
    want = j_reorder.rabbit_order(a)
    got = t_reorder.rabbit_order(b, cap=cap)
    np.testing.assert_array_equal(got, want)
    if cap == 1:
        assert not np.array_equal(got, t_reorder.rabbit_order(b))


def test_permutate_native_matches_numpy_and_jax(monkeypatch):
    """sdb_permutate against the numpy body and JAX's permutate on valued
    and unvalued square matrices with duplicate entries (stable order),
    and a rectangular matrix (rows only, numpy on both paths)."""
    monkeypatch.delenv("SDB_NO_NATIVE", raising=False)
    rng = np.random.default_rng(0)
    for seed, values in ((1, "uniform"), (2, "ones")):
        a = j_csr.random_csr(0.07, 150, 150, seed=seed, values=values)
        dup = j_csr.CSR.from_coo(
            np.concatenate([a.row_ids(), [3, 3]]),
            np.concatenate([np.asarray(a.indices), [7, 7]]),
            None if a.data is None
            else np.concatenate([np.asarray(a.data), [0.5, 0.25]]),
            a.shape,
        )
        perm = rng.permutation(150).astype(np.int64)
        got = t_reorder.permutate(perm, to_port(dup))
        assert_csr_equal(j_reorder.permutate(perm, dup), got)
        assert_csr_equal(got, t_reorder.permutate(perm, to_port(dup), impl="python"))
    rect = j_csr.random_csr(0.1, 40, 70, seed=4)
    perm = rng.permutation(40).astype(np.int64)
    for impl in ("native", "python"):
        assert_csr_equal(j_reorder.permutate(perm, rect),
                         t_reorder.permutate(perm, to_port(rect), impl=impl))
    # the native pass refuses what would index outside its arrays
    square = to_port(dup)
    for bad in (perm, np.arange(1, 151)):
        with pytest.raises(ValueError, match="old2new"):
            t_reorder.permutate(bad, square)
    with pytest.raises(ValueError, match="square"):
        t_reorder.bfs(to_port(rect))
    with pytest.raises(ValueError, match="start"):
        t_reorder.greedy_closest(square, start=150)


@pytest.mark.parametrize("name", ["rcmk", "closest", "gorder"])
def test_reorder_per_component_bit_equal(name, monkeypatch):
    """Per-component reordering of a batch of small graphs."""
    monkeypatch.delenv("SDB_NO_NATIVE", raising=False)
    a, _ = j_ds.synthetic_molecules(n_graphs=12, mean_nodes=9, seed=3)
    b = to_port(a)
    want = j_reorder.reorder_per_component(a, j_reorder.STRATEGIES[name])
    got = t_reorder.reorder_per_component(b, t_reorder.STRATEGIES[name])
    np.testing.assert_array_equal(got, want)
    t_reorder.check_permutation(got, b.n_rows)


def test_metis_partition_rcm_fallback_and_files(graphs, tmp_path, monkeypatch):
    """Without pymetis (made to fail its import), the BFS-bucket
    partition; with a gpmetis partition file; metis_nd with an ndmetis
    .iperm file: each as the JAX package's."""
    monkeypatch.setitem(sys.modules, "pymetis", None)
    a, b = graphs["powerlaw"]
    for n_parts in (1, 7, 64):
        want = j_reorder.metis_partition_rcm(a, n_parts=n_parts)
        for impl in ("native", "python"):
            got = t_reorder.metis_partition_rcm(b, n_parts=n_parts, impl=impl)
            np.testing.assert_array_equal(got, want)
    parts = np.random.default_rng(5).integers(0, 9, size=b.n_rows)
    part_file = tmp_path / "g.part.9"
    np.savetxt(part_file, parts, fmt="%d")
    np.testing.assert_array_equal(
        t_reorder.metis_partition_rcm(b, partition_path=str(part_file)),
        j_reorder.metis_partition_rcm(a, partition_path=str(part_file)))
    np.testing.assert_array_equal(
        t_reorder.partition_rcm(b, parts), j_reorder.partition_rcm(a, parts))
    iperm = np.random.default_rng(6).permutation(b.n_rows)
    iperm_file = tmp_path / "g.iperm"
    np.savetxt(iperm_file, iperm, fmt="%d")
    got = t_reorder.metis_nd(b, iperm_path=str(iperm_file))
    np.testing.assert_array_equal(got, iperm)
    np.testing.assert_array_equal(got, j_reorder.metis_nd(a, iperm_path=str(iperm_file)))
    np.testing.assert_array_equal(t_reorder.metis_nd(b), j_reorder.metis_nd(a))
    with pytest.raises(ValueError, match="entries"):
        t_reorder.load_partition(str(part_file), b.n_rows + 1)


def test_failed_build_raises_and_python_still_runs(graphs, tmp_path, monkeypatch):
    """No silent fallback: with no compiler the native path raises with
    the compiler's failure, the plain path answers, and an unknown impl
    is refused. The engine's source is the port's own."""
    assert t_native.SOURCE.is_relative_to(
        t_native.Path(t_reorder.__file__).resolve().parents[1])
    b = graphs["powerlaw"][1]
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="native reorder engine"):
        t_reorder.rcm_variant(b)
    with pytest.raises(RuntimeError, match="native reorder engine"):
        t_reorder.permutate(np.arange(b.n_rows), b)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="exited 1"):
        t_reorder.gorder(b)
    # the library is named by the compiler and the machine too, so one
    # built by another compiler or for another architecture is not loaded
    names = {t_native.library_path().name}
    monkeypatch.setenv("CXX", "g++")
    names.add(t_native.library_path().name)
    monkeypatch.setattr(t_native.platform, "machine", lambda: "another-arch")
    names.add(t_native.library_path().name)
    assert len(names) == 3
    t_reorder.check_permutation(t_reorder.rcm_variant(b, impl="python"), b.n_rows)
    with pytest.raises(ValueError, match="impl"):
        t_reorder.bfs(b, impl="cuda")
