"""The port's router against the JAX package's: with every PLANNERS entry
of both packages replaced by a recorder, spmm_plan hands the same tier
the same matrix (bit for bit: the CSR, the repacked BSR, the divided
Hybrid, the cut Windowed) and the same arguments (the threshold, compact=
and feat_dim=; the port adds device=) on each route: the fill guard, the
scored branch over the byte budget, the small-b repack, the explicit
hybrid and windowed tiers on a CSR input, Hybrid and Windowed inputs
under "auto", repack_to= and the int8 mapping. tune_with= and
operand_layout="col" are held to JAX's in tests/test_torch_tune.py."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmm_denseblock_tpu.formats.bsr as j_bsr
import spmm_denseblock_tpu.formats.csr as j_csr
import spmm_denseblock_tpu.formats.windowed as j_win
import spmm_denseblock_tpu.models as j_models
import spmm_denseblock_tpu_torch.formats.bsr as t_bsr
import spmm_denseblock_tpu_torch.formats.csr as t_csr
import spmm_denseblock_tpu_torch.formats.windowed as t_win
import spmm_denseblock_tpu_torch.models as t_models
from test_torch_hybrid import community_adj

JD = importlib.import_module("spmm_denseblock_tpu.ops.dispatch")
TD = importlib.import_module("spmm_denseblock_tpu_torch.ops.dispatch")
JDIV = importlib.import_module("spmm_denseblock_tpu.convert.divide")

torch.set_num_threads(2)


def _recorders(monkeypatch):
    """Replace every planner of both routers by a recorder of (impl,
    matrix, keyword arguments); returns the two call lists."""
    calls = {"jax": [], "torch": []}
    for key, mod in (("jax", JD), ("torch", TD)):
        for name in list(mod.PLANNERS):
            monkeypatch.setitem(
                mod.PLANNERS, name,
                lambda m, _n=name, _c=calls[key], **kw: _c.append((_n, m, kw)))
    return calls


def _arrays(m):
    """A matrix's defining arrays and sizes, in a form that compares the
    two packages' objects bit for bit."""
    kind = type(m).__name__
    if kind == "CSR":
        return ("CSR", tuple(m.shape), np.asarray(m.indptr), np.asarray(m.indices),
                None if m.data is None else np.asarray(m.data))
    if kind == "BSR":
        n = m.nnzb
        return ("BSR", tuple(m.shape), m.block_size, n, np.asarray(m.block_rows)[:n],
                np.asarray(m.block_cols)[:n], np.asarray(m.blocks)[:n])
    if kind == "Hybrid":
        return ("Hybrid", _arrays(m.dense), _arrays(m.remainder))
    return ("Windowed", tuple(m.shape), m.tile_rows, m.window, np.asarray(m.tiles),
            np.asarray(m.win_idx), _arrays(m.remainder))


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _dtype_free(kw):
    """kwargs without device=, dtypes (jax or torch) as their names."""
    out = {}
    for k, v in kw.items():
        if k == "device":
            continue
        if k == "dtype" and v is not None:
            v = str(jnp.dtype(v)) if not isinstance(v, torch.dtype) else \
                str(v).replace("torch.", "")
        out[k] = v
    return out


def route(monkeypatch, j_mat, t_mat, **kw):
    """Both routers on the same matrix: asserts the same planner, matrix
    and arguments, and returns (impl, the port's matrix, its kwargs)."""
    calls = _recorders(monkeypatch)
    jkw, tkw = dict(kw), dict(kw, device="cpu")
    if kw.get("dtype") == "int8":
        jkw["dtype"], tkw["dtype"] = jnp.int8, torch.int8
    elif kw.get("dtype") == "bfloat16":
        jkw["dtype"], tkw["dtype"] = jnp.bfloat16, torch.bfloat16
    JD.spmm_plan(j_mat, **jkw)
    TD.spmm_plan(t_mat, **tkw)
    (jn, jm, jk), (tn, tm, tk) = calls["jax"][0], calls["torch"][0]
    assert tn == jn
    _same(_arrays(tm), _arrays(jm))
    assert _dtype_free(tk) == _dtype_free(jk)
    assert tk["device"] == torch.device("cpu")
    return tn, tm, tk


def weak_pair(p=0.002, n=1024, seed=0):
    return (j_csr.random_csr(p, n, seed=seed, values="ones"),
            t_csr.random_csr(p, n, seed=seed, values="ones"))


@pytest.mark.parametrize("feat_dim", [None, 64, 512])
@pytest.mark.parametrize("dtype", [None, "int8", "bfloat16"])
def test_fill_guard(dtype, feat_dim, monkeypatch):
    """Past 32x zero fill within the budget: csr_ell (csr_ell_int8 with
    int8, dtype dropped), compact="auto", feat_dim passed when given."""
    jc, tc = weak_pair()
    impl, _, kw = route(monkeypatch, jc, tc, impl="auto", block_size=128,
                        feat_dim=feat_dim, dtype=dtype, grad=False)
    assert impl == ("csr_ell_int8" if dtype == "int8" else "csr_ell")
    assert kw["compact"] == "auto"
    assert kw.get("feat_dim") == feat_dim
    assert (kw.get("dtype") is not None) == (dtype == "bfloat16")


@pytest.mark.parametrize("dtype", [None, "int8", "bfloat16"])
@pytest.mark.parametrize("budget", [100_000, 140_000, 20_000])
def test_scored_branch(budget, dtype, monkeypatch):
    """Over a small bsr_bytes_budget the scorer decides, with the
    operand's bytes: a hybrid divided at its threshold (the same Hybrid,
    bit for bit) at 100,000 bytes, csr_ell at 20,000 in f32 (the dense
    parts worth their blocks exceed a quarter of it)."""
    jc, tc = community_adj()
    impl, m, kw = route(monkeypatch, jc, tc, impl="auto", block_size=32, feat_dim=16,
                        bsr_bytes_budget=budget, dtype=dtype, grad=False)
    base = impl.replace("_int8", "")
    assert base in ("hybrid", "csr_ell")
    assert impl.endswith("_int8") == (dtype == "int8")
    assert type(m).__name__ == ("Hybrid" if base == "hybrid" else "CSR")
    if dtype is None:
        assert base == ("csr_ell" if budget == 20_000 else "hybrid")
    assert kw["compact"] == "auto" and kw["feat_dim"] == 16
    assert "bsr_bytes_budget" not in kw


def test_scored_branch_without_a_dense_part(monkeypatch):
    """A uniform random graph over the budget: no threshold beats pure ELL
    by the 2% margin, so csr_ell."""
    jc, tc = (j_models.sym_norm_adjacency(j_csr.random_csr(0.05, 256, seed=2)),
              t_models.sym_norm_adjacency(t_csr.random_csr(0.05, 256, seed=2)))
    impl, m, _ = route(monkeypatch, jc, tc, impl="auto", block_size=32,
                       bsr_bytes_budget=10_000, grad=False)
    assert impl == "csr_ell" and type(m).__name__ == "CSR"


@pytest.mark.parametrize("feat_dim", [None, 64])
@pytest.mark.parametrize("b,p", [(8, 0.3), (16, 0.3), (16, 0.01), (32, 0.3)])
def test_small_b_repack_route(b, p, feat_dim, monkeypatch):
    """A BSR input of b < 32 is repacked to 128 when the small-b score
    says so (then wide operands take bsr_pallas), else routed as it is
    (bsr_xla below b = 64)."""
    src = t_bsr.random_bsr(p, 32, 32, block_size=b, seed=3)
    parts = (src.block_rows, src.block_cols, src.blocks, src.shape, b)
    jb, tb = j_bsr.BSR.from_parts(*parts), t_bsr.BSR.from_parts(*parts)
    impl, m, _ = route(monkeypatch, jb, tb, impl="auto", feat_dim=feat_dim, grad=False)
    repacked = b < 32 and TD._prefer_repack128(tb)
    assert m.block_size == (128 if repacked else b)
    assert impl == ("bsr_pallas" if repacked and feat_dim is None else "bsr_xla")
    if (b, p) == (8, 0.3):
        assert repacked
    impl, m, _ = route(monkeypatch, jb, tb, impl="bsr_pallas", repack_to=4 * b,
                       grad=False)
    assert impl == "bsr_pallas" and m.block_size == 4 * b


@pytest.mark.parametrize("kw", [{}, {"density_threshold": 0.05},
                                {"dtype": "int8"}, {"dtype": "bfloat16"},
                                {"impl": "hybrid_int8"}])
def test_explicit_hybrid_on_csr(kw, monkeypatch):
    """impl="hybrid" on a CSR input: divided at density_threshold=, else
    at the scorer's pick with margin 0 (int8: scored at 1 byte), else at
    auto_threshold; no compact= (only "auto" sets it)."""
    jc, tc = community_adj()
    kw = {"impl": "hybrid", **kw}
    impl, m, tk = route(monkeypatch, jc, tc, block_size=32, grad=False, **kw)
    int8 = kw.get("dtype") == "int8" or kw["impl"] == "hybrid_int8"
    assert impl == ("hybrid_int8" if int8 else "hybrid")
    assert type(m).__name__ == "Hybrid" and m.dense.nnzb > 0
    assert "compact" not in tk and "density_threshold" not in tk
    if "density_threshold" not in kw:
        thr, _ = JDIV.score_thresholds(
            jc, 32, candidates={0.015, 0.02, 0.03, 0.05, JDIV.auto_threshold(jc, 32)},
            margin=0.0, dtype_bytes=1 if int8 else 2 if kw.get("dtype") else 4)
        assert m.dense.nnzb == JDIV.divide(jc, 32, thr).dense.nnzb


def test_explicit_hybrid_falls_back_to_auto_threshold(monkeypatch):
    """When no candidate qualifies, the densest blocks only
    (auto_threshold)."""
    jc, tc = (j_models.sym_norm_adjacency(j_csr.random_csr(0.05, 256, seed=2)),
              t_models.sym_norm_adjacency(t_csr.random_csr(0.05, 256, seed=2)))
    impl, m, _ = route(monkeypatch, jc, tc, impl="hybrid", block_size=32, grad=False)
    assert impl == "hybrid" and type(m).__name__ == "Hybrid"


@pytest.mark.parametrize("impl,kw", [
    ("windowed", {}), ("windowed", {"tile_rows": 32, "window": 64, "n_windows": 2}),
    ("windowed", {"min_fill": 0.01, "window": 128}),
    ("windowed", {"dtype": "int8", "tile_rows": 16}),
    ("windowed_int8", {}), ("windowed_int8", {"window": 128, "n_windows": 3})])
def test_explicit_windowed_on_csr(impl, kw, monkeypatch):
    """impl="windowed*" on a CSR input cuts its tiles with tile_rows=,
    window=, min_fill=, n_windows=; dtype=int8 maps to windowed_int8."""
    jc, tc = community_adj()
    got, m, tk = route(monkeypatch, jc, tc, impl=impl, **kw)
    assert type(m).__name__ == "Windowed"
    assert got == ("windowed_int8" if impl == "windowed_int8" or kw.get("dtype")
                   else "windowed")
    assert not {"tile_rows", "window", "min_fill", "n_windows"} & set(tk)


@pytest.mark.parametrize("dtype", [None, "int8"])
def test_composite_inputs_under_auto(dtype, monkeypatch):
    """A Windowed input under "auto" runs windowed, a Hybrid one hybrid
    (with compact="auto"); int8 maps both."""
    jc, tc = community_adj()
    jw = j_win.divide_windowed(jc, tile_rows=32, window=64)
    tw = t_win.divide_windowed(tc, tile_rows=32, window=64)
    impl, _, kw = route(monkeypatch, jw, tw, impl="auto", dtype=dtype)
    assert impl == ("windowed_int8" if dtype else "windowed") and "compact" not in kw
    jh = JDIV.divide(jc, 32, 0.1)
    th = importlib.import_module("spmm_denseblock_tpu_torch.convert.divide").divide(
        tc, 32, 0.1)
    impl, _, kw = route(monkeypatch, jh, th, impl="auto", dtype=dtype, feat_dim=32)
    assert impl == ("hybrid_int8" if dtype else "hybrid")
    assert kw["compact"] == "auto" and kw["feat_dim"] == 32


@pytest.mark.parametrize("impl,want", [("bsr_pallas", "bsr_int8_pallas"),
                                       ("bsr_xla", "bsr_int8"),
                                       ("csr_ell", "csr_ell_int8"),
                                       ("csr_pallas", "csr_pallas")])
def test_int8_mapping(impl, want, monkeypatch):
    """dtype=int8 maps a named tier to its quantized variant (and drops
    dtype); a tier without one gets the dtype (and its planner refuses
    it, as in JAX)."""
    jc, tc = weak_pair(0.05, 256)
    got, _, kw = route(monkeypatch, jc, tc, impl=impl, block_size=32, dtype="int8")
    assert got == want
    assert ("dtype" in kw) == (want == "csr_pallas")
    assert "compact" not in kw


def test_router_rejections():
    """An unknown layout or impl raises as in JAX."""
    _, tc = weak_pair(0.05, 64)
    with pytest.raises(ValueError, match="operand_layout"):
        TD.spmm_plan(tc, operand_layout="diag", device="cpu")
    with pytest.raises(KeyError, match="unknown impl"):
        TD.spmm_plan(tc, impl="ellpack", device="cpu")
    assert not hasattr(TD, "_NOT_PORTED")
    assert set(TD.PLANNERS) == set(JD.PLANNERS)
