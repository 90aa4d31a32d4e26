"""The router's last pieces against the JAX package's, on the CPU:

- spmm_tune on JAX's two cases (tests/test_ops.py:197-219): the same
  report labels, report["best"] among the candidates, the answer within
  1e-4 of spmm_scipy; with both packages' timers replaced by the same
  scripted times, the same report and winner; a candidate whose planner
  rejects the input, or that runs out of memory, gets an error entry; a
  CUDA launch failure or a fault the card reports is raised (the launcher's
  RuntimeError and torch.AcceleratorError, stubbed: the card test in
  test_torch_cuda_kernels.py makes a real refused launch);
- tune_with=: with spmm_tune replaced by a recorder in both packages,
  "auto" asks for the same two finalists (the same threshold and
  keyword arguments) on the same matrix where the scorer's margin is
  thin, and for none where it is not; unrecorded, its plan is within
  1e-4 of scipy (tests/test_ops.py:672-693);
- operand_layout="col" (tests/test_plan.py:262-285): the plan of B^T
  equals the row plan bit for bit, and JAX's col plan within 1e-5 of max
  |JAX| (f32 sum order), for bsr_pallas on each forced layout, csr_ell
  and csr_pallas, with the gradient of B^T through transb_plan against
  jax.grad."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import spmm_denseblock_tpu.formats.bsr as j_bsr
import spmm_denseblock_tpu.formats.csr as j_csr
import spmm_denseblock_tpu.models as j_models
import spmm_denseblock_tpu_torch.formats.bsr as t_bsr
import spmm_denseblock_tpu_torch.formats.csr as t_csr
import spmm_denseblock_tpu_torch.models as t_models
from spmm_denseblock_tpu_torch.ops import Plan, assert_allclose, spmm_scipy
from test_torch_dispatch import _arrays, _dtype_free, _recorders, _same
from test_torch_hybrid import community_adj

JD = importlib.import_module("spmm_denseblock_tpu.ops.dispatch")
TD = importlib.import_module("spmm_denseblock_tpu_torch.ops.dispatch")
JT = importlib.import_module("spmm_denseblock_tpu.bench.timing")
TT = importlib.import_module("spmm_denseblock_tpu_torch.bench.timing")

torch.set_num_threads(2)

TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _x(n, F, seed=0):
    return np.random.default_rng(seed).standard_normal((n, F)).astype(np.float32)


def _pair(p, n, seed):
    return (j_csr.random_csr(p, n, n, seed=seed, values="ones"),
            t_csr.random_csr(p, n, n, seed=seed, values="ones"))


# -- spmm_tune ------------------------------------------------------------------

TUNE_CASES = {
    "bsr_xla vs csr_xla": (("bsr_xla", "csr_xla"), {"block_size": 16}),
    "compact off vs force": (
        ("csr_ell", ("csr_ell", {"compact": "force", "compact_slots": 128})), {}),
}


@pytest.mark.parametrize("case", list(TUNE_CASES))
def test_spmm_tune_picks_a_winner(case):
    candidates, kw = TUNE_CASES[case]
    jc, tc = _pair(0.05, 96, 3)
    x = _x(96, 16, 1234)
    plan, report = TD.spmm_tune(tc, x, candidates=candidates, device="cpu", **kw)
    _, j_report = JD.spmm_tune(jc, x, candidates=candidates, **kw)
    assert set(report) == set(j_report)
    labels = [c if isinstance(c, str) else
              f"{c[0]}({', '.join(sorted(c[1]))})" for c in candidates]
    assert report["best"] in labels
    assert all(report[k]["ms"] > 0 for k in labels)
    assert_allclose(plan(x), spmm_scipy(tc, x))


def test_spmm_tune_same_report_on_the_same_times(monkeypatch):
    """Both timers scripted with the same seconds per candidate: the same
    report, the same winner (the second candidate, the fastest)."""
    for mod in (JT, TT):
        times = iter([3e-3, 1e-3, 2e-3])
        monkeypatch.setattr(mod, "time_synced",
                            lambda f, x, iters=8, _t=times: next(_t))
    jc, tc = _pair(0.05, 96, 3)
    x = _x(96, 8)
    cands = ("bsr_xla", ("csr_ell", {"compact": "auto"}), "csr_xla")
    plan, report = TD.spmm_tune(tc, x, candidates=cands, block_size=16, device="cpu")
    _, j_report = JD.spmm_tune(jc, x, candidates=cands, block_size=16)
    assert report == j_report
    assert report["best"] == "csr_ell(compact)"
    assert isinstance(plan, Plan)


def test_spmm_tune_reports_rejected_candidates(monkeypatch):
    """A planner that rejects the input (an unknown impl), or a candidate
    that runs out of device memory, gets an error entry and the others
    are still timed; with no candidate left, RuntimeError."""
    jc, tc = _pair(0.05, 96, 3)
    x = _x(96, 8)
    _, report = TD.spmm_tune(tc, x, candidates=("ellpack", "csr_xla"), device="cpu")
    _, j_report = JD.spmm_tune(jc, x, candidates=("ellpack", "csr_xla"))
    assert set(report) == set(j_report) == {"ellpack", "csr_xla", "best"}
    assert "unknown impl" in report["ellpack"]["error"]
    assert report["best"] == "csr_xla"

    def oom(m, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")

    monkeypatch.setitem(TD.PLANNERS, "bsr_xla", oom)
    _, report = TD.spmm_tune(tc, x, candidates=("bsr_xla", "csr_xla"), device="cpu")
    assert "out of memory" in report["bsr_xla"]["error"]
    assert report["best"] == "csr_xla"
    with pytest.raises(RuntimeError, match="no candidate worked"):
        TD.spmm_tune(tc, x, candidates=("bsr_xla", "ellpack"), device="cpu")


@pytest.mark.parametrize("fault", [
    RuntimeError("sdb_csr_spmm: launch failed with cudaError_t 1"),
    torch.AcceleratorError("CUDA error: an illegal memory access was encountered"),
])
def test_spmm_tune_raises_device_faults(fault, monkeypatch):
    """A CUDA launch failure or a fault the card reports leaves the device
    unusable: spmm_tune raises it instead of reporting the candidate."""
    def faulty(m, **kw):
        raise fault

    monkeypatch.setitem(TD.PLANNERS, "bsr_xla", faulty)
    _, tc = _pair(0.05, 96, 3)
    with pytest.raises(type(fault), match=str(fault)[:20]):
        TD.spmm_tune(tc, _x(96, 8), candidates=("csr_xla", "bsr_xla"), device="cpu")


# -- tune_with= ---------------------------------------------------------------


def _thin_community(seed=0, n=256):
    """Two 32-node communities and a random tail, normalized: at b = 32
    the scorer's best hybrid (threshold 0.25) beats pure ELL by 11%."""
    rng = np.random.default_rng(seed)
    e = np.concatenate([rng.integers(0, 32, (200, 2)), rng.integers(64, 96, (200, 2)),
                        rng.integers(0, n, (600, 2))])
    e = np.concatenate([e, e[:, ::-1]])
    return (j_models.sym_norm_adjacency(j_csr.CSR.from_edges(e, n)),
            t_models.sym_norm_adjacency(t_csr.CSR.from_edges(e, n)))


def _test_ops_case():
    """tests/test_ops.py:672-693's matrix: no block passes a threshold,
    so the hybrid scores tie pure ELL's (thin, no best threshold)."""
    a = sp.random(512, 512, density=0.03, random_state=4, format="csr")
    a.data[:] = 1.0
    return j_csr.CSR.from_scipy(a), t_csr.CSR.from_scipy(a)


THIN = {  # name: (matrices, block_size, budget, finalists asked for)
    "no dense part": (_test_ops_case, 64, 1 << 16, True),
    "hybrid by 11%": (_thin_community, 32, 1 << 16, True),
    "hybrid by 44%": (lambda: community_adj(), 32, 1 << 16, False),
}


@pytest.mark.parametrize("name", list(THIN))
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_tune_with_asks_for_jax_finalists(name, dtype, monkeypatch):
    make, b, budget, thin = THIN[name]
    jm, tm = make()
    x = _x(tm.n_cols, 16)
    tuned = {"jax": [], "torch": []}
    for key, mod in (("jax", JD), ("torch", TD)):
        monkeypatch.setattr(
            mod, "spmm_tune",
            lambda m, tw, _c=tuned[key], **kw: (_c.append((m, tw, kw)), ("tuned", {}))[1])
    planned = _recorders(monkeypatch)
    kw = dict(impl="auto", block_size=b, bsr_bytes_budget=budget, tune_with=x)
    jkw, tkw = dict(kw), dict(kw, device="cpu")
    if dtype:
        jkw["dtype"], tkw["dtype"] = jnp.bfloat16, torch.bfloat16
    j_out = JD.spmm_plan(jm, **jkw)
    t_out = TD.spmm_plan(tm, **tkw)
    assert len(tuned["torch"]) == len(tuned["jax"]) == int(thin)
    if not thin:  # the scorer's route, as without tune_with
        assert planned["torch"][0][0] == planned["jax"][0][0] == "hybrid"
        return
    assert t_out == j_out == "tuned" and not planned["torch"]
    (jmat, jtw, jk), (tmat, ttw, tk) = tuned["jax"][0], tuned["torch"][0]
    _same(_arrays(tmat), _arrays(jmat))
    assert ttw is x and jtw is x
    assert tk["candidates"] == jk["candidates"]
    assert tk["candidates"][0][0] == "hybrid"
    assert tk["device"] == torch.device("cpu")
    assert _dtype_free(tk) == _dtype_free(jk)


def test_tune_with_fallback_matches_scipy():
    """Unrecorded, the tuned plan (or the scorer's, without tune_with)
    is within 1e-4 of scipy."""
    for make, b in ((_test_ops_case, 64), (_thin_community, 32)):
        _, tm = make()
        x = _x(tm.n_cols, 16, 5)
        want = spmm_scipy(tm, x)
        for tw in (None, x):
            plan = TD.spmm_plan(tm, impl="auto", block_size=b,
                                bsr_bytes_budget=1 << 16, tune_with=tw, device="cpu")
            assert _rel(plan(x), want) < 1e-4


# -- operand_layout="col" -----------------------------------------------------

COL = {  # name: (impl, planner kwargs)
    "bsr_pallas sorted": ("bsr_pallas", {"depth_sort": True}),
    "bsr_pallas flat": ("bsr_pallas", {"depth_sort": False, "resident": False}),
    "bsr_pallas resident": ("bsr_pallas", {"depth_sort": False, "resident": True}),
    "bsr_xla": ("bsr_xla", {}),
    "csr_ell": ("csr_ell", {}),
    "csr_pallas": ("csr_pallas", {}),
}


@pytest.mark.parametrize("name", list(COL))
def test_col_layout_equals_row_and_jax(name):
    impl, kw = COL[name]
    if impl.startswith("bsr"):
        jm = j_bsr.random_bsr(0.3, 12, 12, block_size=8, seed=7)
        tm = t_bsr.random_bsr(0.3, 12, 12, block_size=8, seed=7)
    else:
        jm, tm = (j_csr.random_csr(0.08, 96, 96, seed=8),
                  t_csr.random_csr(0.08, 96, 96, seed=8))
    x = _x(96, 24, 3)
    g = _x(96, 24, 4)
    row = TD.spmm_plan(tm, impl=impl, device="cpu", **kw)
    col = TD.spmm_plan(tm, impl=impl, operand_layout="col", device="cpu", **kw)
    j_col = JD.spmm_plan(jm, impl=impl, operand_layout="col", **kw)
    assert isinstance(col, Plan)

    xt = torch.tensor(x.T, requires_grad=True)
    out = col(xt)
    np.testing.assert_array_equal(out.detach().numpy(), row(x).detach().numpy())
    want = np.asarray(j_col(jnp.asarray(x.T)))
    assert _rel(out.detach().numpy(), want) < TOL
    (out * torch.as_tensor(g)).sum().backward()
    j_grad = jax.grad(lambda v: jnp.sum(j_col(v) * g))(jnp.asarray(x.T))
    assert xt.grad.shape == (24, 96)
    assert _rel(xt.grad.numpy(), np.asarray(j_grad)) < TOL
