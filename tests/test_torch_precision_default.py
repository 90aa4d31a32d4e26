"""precision="default" of the port against the JAX package: the TPU's one
bf16 pass (jax.lax.Precision.DEFAULT: both operands rounded to bf16,
products and sums in f32) on K1, K5 (resident=True) and K10.

- Layout: the BSR plan takes the flat layout (K1, or K5 with
  resident=True) as JAX's does, never the sorted or row-group one; the
  packed index arrays equal JAX's, and the blocks (K10: the values) equal
  JAX's rounded to bf16 to nearest even, which is what the port holds.
  grad=True builds Aᵀ's plan the same way.
- Exactness: on ops.reference.bf16_exact_case (BSR) and on an integer CSR
  case every value is an integer of magnitude <= 16, exact in bf16, and
  every sum an integer under 2^24. One bf16 pass and exact f32 then give
  the same answer, so the port's answer and its backward's gradient must
  equal JAX's (whose CPU interpret mode computes exact f32) and float64
  bit for bit.
- General seeded inputs: the port's "default" plan equals its bf16 plan
  (K10: its f32 plan) run on the blocks and operand rounded beforehand
  within 1e-6, and lies within 3e-2 (the bf16 tier's gate,
  tests/test_conformance.py) of float64 and of JAX's CPU answer, which
  is exact f32, not rounded (the BSR test checks that as well).
- spmm_plan passes precision="default" to both planners, and
  dist_bsr_spmm_plan(local_impl="pallas", precision="default") on a
  2-rank gloo world takes JAX's layout tag and the exact answer.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmm_denseblock_tpu.formats.bsr as j_bsr
import spmm_denseblock_tpu.formats.csr as j_csr
import spmm_denseblock_tpu.ops as j_ops
import spmm_denseblock_tpu_torch.formats.bsr as t_bsr
import spmm_denseblock_tpu_torch.formats.csr as t_csr
import spmm_denseblock_tpu_torch.ops as t_ops
from spmm_denseblock_tpu_torch.ops.reference import bf16_exact_case
from torch_parallel_cases import port_bsr, world_results
from torch_parallel_jax import check, jax_plan

J = importlib.import_module("spmm_denseblock_tpu.ops.bsr_spmm_pallas")
T = importlib.import_module("spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas")
JC = importlib.import_module("spmm_denseblock_tpu.ops.csr_spmm_pallas")
TC = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm_pallas")

torch.set_num_threads(2)

BF16_TOL = 3e-2  # tests/test_conformance.py's bf16 gate
DTYPES = {"f32": (None, None), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bf16(a) -> torch.Tensor:
    """a rounded to bf16 to nearest even (as the port's plans round)."""
    return torch.as_tensor(np.array(a, np.float32)).to(torch.bfloat16)


def _jax_bsr(bsr):
    return j_bsr.BSR.from_parts(np.asarray(bsr.block_rows), np.asarray(bsr.block_cols),
                                np.asarray(bsr.blocks), tuple(bsr.shape), bsr.b)


def _bsr_plans(bsr, dtype: str, resident, grad: bool):
    tdt, jdt = DTYPES[dtype]
    kw = {} if resident is None else {"resident": resident}
    tp = T.bsr_spmm_pallas_plan(bsr, dtype=tdt, precision="default", grad=grad,
                                device="cpu", **kw)
    jp = J.bsr_spmm_pallas_plan(_jax_bsr(bsr), dtype=jdt, precision="default",
                                grad=grad, **kw)
    return tp, jp


def _int_csr(seed: int, n_rows: int = 300, n_cols: int = 200, nnz: int = 3000):
    """An integer CSR case: values and operand integers of magnitude <= 16,
    two empty rows and a row of 700 nonzeros (longer than a K10 segment).
    Returns (port CSR, JAX CSR, x, float64 A @ x)."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([rng.integers(0, n_rows, nnz), np.full(700, 5)])
    rows = np.where(np.isin(rows, (7, 8)), 9, rows)
    cols = rng.integers(0, n_cols, rows.size)
    vals = rng.integers(-16, 17, rows.size).astype(np.float32)
    tc = t_csr.CSR.from_coo(rows, cols, vals, (n_rows, n_cols))
    jc = j_csr.CSR.from_coo(rows, cols, vals, (n_rows, n_cols))
    x = rng.integers(-16, 17, size=(n_cols, 24)).astype(np.float32)
    a = np.zeros((n_rows, n_cols))
    np.add.at(a, (rows, cols), vals.astype(np.float64))
    assert (np.abs(a) @ np.abs(x.astype(np.float64))).max() < 2.0 ** 24
    return tc, jc, x, a @ x.astype(np.float64)


# -- K1 and K5: the BSR plan -------------------------------------------------


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("resident", [None, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bsr_default_layout_and_arrays(dtype, resident, grad):
    """At >= 8 real blocks a block-row, where an exact f32 or bf16 plan
    sorts, a "default" plan packs the flat layout in both packages (K5's
    tag with resident=True); its arrays are JAX's, the blocks rounded to
    bf16, and grad=True does the same for Aᵀ."""
    bsr = t_bsr.random_bsr(0.6, 12, 10, block_size=16, seed=5)
    tp, jp = _bsr_plans(bsr, dtype, resident, grad)
    pairs = list(zip(tp.arrays, jp.arrays)) if grad else [(tp, jp)]
    for t, j in pairs:
        assert t.statics[0] == ("resident" if resident else "flat")
        assert j.statics[-1] is None and j.statics[-2] == resident  # JAX: flat
        assert t.statics[5] == ("bf16" if dtype == "f32" else "exact")
        for a, b in zip(j.arrays[:2], t.arrays[:2]):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert t.arrays[2].dtype == torch.bfloat16
        assert torch.equal(t.arrays[2], _bf16(np.asarray(j.arrays[2].astype(jnp.float32))))


@pytest.mark.parametrize("b", [16, 64])
@pytest.mark.parametrize("resident", [None, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bsr_default_exact_case_bit_exact(dtype, resident, b):
    """On bf16_exact_case the port's K1/K5 "default" answer equals JAX's
    and float64 bit for bit, and so does the backward's gradient
    (Aᵀ @ g, g integers of magnitude <= 16)."""
    bsr, x, want = bf16_exact_case(b, 24)
    tp, jp = _bsr_plans(bsr, dtype, resident, grad=True)
    g = np.random.default_rng(b).integers(-16, 17, size=want.shape).astype(np.float32)
    xt = torch.as_tensor(x).requires_grad_(True)
    out = tp(xt)
    (out * torch.as_tensor(g)).sum().backward()
    jout, vjp = jax.vjp(lambda v: jp(v), jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out.detach().numpy(), want.astype(np.float32))
    grad64 = bsr.to_dense().astype(np.float64).T @ g.astype(np.float64)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgrad))
    np.testing.assert_array_equal(xt.grad.numpy(), grad64.astype(np.float32))


@pytest.mark.parametrize("resident", [None, True])
def test_bsr_default_is_one_bf16_pass(resident):
    """On normal data the f32 "default" plan is the bf16 plan on the blocks
    and operand rounded beforehand (1e-6), within 3e-2 of float64 and of
    JAX's CPU answer; JAX's CPU answer is exact f32 (it equals its
    precision=None plan's), so the port's rounding is the only gap."""
    src = t_bsr.random_bsr(0.3, 12, 12, block_size=16, seed=3)
    x = np.random.default_rng(4).standard_normal((src.shape[1], 40)).astype(np.float32)
    tp, jp = _bsr_plans(src, "f32", resident, grad=False)
    got = tp(x).numpy()
    rounded = t_bsr.BSR.from_parts(src.block_rows, src.block_cols,
                                   _bf16(src.blocks).float().numpy(), src.shape, 16)
    kw = {"resident": resident if resident else False}
    bf = T.bsr_spmm_pallas_plan(rounded, dtype=torch.bfloat16, precision="default",
                                grad=False, device="cpu", **kw)
    assert _rel(got, bf(_bf16(x).float()).numpy()) < 1e-6
    want = src.to_dense().astype(np.float64) @ x.astype(np.float64)
    assert 0 < _rel(got, want) < BF16_TOL
    jax_out = np.asarray(jp(x))
    exact = J.bsr_spmm_pallas_plan(_jax_bsr(src), grad=False, depth_sort=False,
                                   **({} if resident is None else {"resident": True}))
    np.testing.assert_array_equal(jax_out, np.asarray(exact(x)))
    assert _rel(got, jax_out) < BF16_TOL


def test_bsr_highest_on_bf16_still_raises():
    """The TPU compiler refuses "highest" on bf16 operands; so does the
    port, with grad too."""
    bsr = t_bsr.random_bsr(0.3, 4, 4, block_size=8, seed=0)
    for grad in (False, True):
        with pytest.raises(NotImplementedError, match="highest"):
            T.bsr_spmm_pallas_plan(bsr, dtype=torch.bfloat16, precision="highest",
                                   grad=grad, device="cpu")


# -- K10: the CSR plan -------------------------------------------------------


@pytest.mark.parametrize("grad", [False, True])
def test_csr_default_layout_and_arrays(grad):
    """The band layout is JAX's, the values rounded to bf16 (the only
    array "default" changes), for A and, with grad=True, Aᵀ."""
    tc, jc, _, _ = _int_csr(1)
    kw = dict(precision="default", grad=grad, chunk=128, row_band=64)
    tp = TC.csr_spmm_pallas_plan(tc, device="cpu", **kw)
    jp = JC.csr_spmm_pallas_plan(jc, **kw)
    pairs = list(zip(tp.arrays, jp.arrays)) if grad else [(tp, jp)]
    for t, j in pairs:
        assert t.arrays[2].dtype == torch.bfloat16
        for i, (a, b) in enumerate(zip(j.arrays, t.arrays)):
            if i == 2:
                assert torch.equal(b, _bf16(np.asarray(a)))
            else:
                np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_csr_default_integer_case_bit_exact():
    """On the integer CSR case the port's K10 "default" answer and its
    gradient equal JAX's and float64 bit for bit."""
    tc, jc, x, want = _int_csr(2)
    tp = TC.csr_spmm_pallas_plan(tc, precision="default", device="cpu")
    jp = JC.csr_spmm_pallas_plan(jc, precision="default")
    g = np.random.default_rng(3).integers(-16, 17, size=want.shape).astype(np.float32)
    xt = torch.as_tensor(x).requires_grad_(True)
    out = tp(xt)
    (out * torch.as_tensor(g)).sum().backward()
    jout, vjp = jax.vjp(lambda v: jp(v), jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out.detach().numpy(), want.astype(np.float32))
    a = tc.to_scipy().toarray().astype(np.float64)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgrad))
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  (a.T @ g.astype(np.float64)).astype(np.float32))


def test_csr_default_is_one_bf16_pass():
    """On normal data K10 "default" equals the f32 plan on the values and
    operand rounded beforehand (1e-6), and lies within 3e-2 of float64
    and of JAX's CPU answer."""
    rng = np.random.default_rng(5)
    rows, cols = rng.integers(0, 250, 4000), rng.integers(0, 180, 4000)
    vals = rng.standard_normal(4000).astype(np.float32)
    tc = t_csr.CSR.from_coo(rows, cols, vals, (250, 180))
    jc = j_csr.CSR.from_coo(rows, cols, vals, (250, 180))
    x = rng.standard_normal((180, 33)).astype(np.float32)
    got = TC.csr_spmm_pallas_plan(tc, precision="default", grad=False, device="cpu")(x)
    rounded = t_csr.CSR(tc.indptr, tc.indices, _bf16(tc.values()).float().numpy(), tc.shape)
    f32 = TC.csr_spmm_pallas_plan(rounded, grad=False, device="cpu")
    assert _rel(got, f32(_bf16(x).float())) < 1e-6
    want = tc.to_scipy().toarray().astype(np.float64) @ x.astype(np.float64)
    assert 0 < _rel(got, want) < BF16_TOL
    jax_out = np.asarray(JC.csr_spmm_pallas_plan(jc, precision="default", grad=False)(x))
    assert _rel(got, jax_out) < BF16_TOL


# -- the router and the distributed plan -------------------------------------


@pytest.mark.parametrize("impl", ["bsr_pallas", "csr_pallas"])
def test_spmm_plan_passes_default(impl):
    """spmm_plan reaches both planners with precision="default" as JAX's
    router does: the same layout, and on integers the same answer."""
    tc, jc, x, want = _int_csr(6)
    tp = t_ops.spmm_plan(tc, impl=impl, block_size=16, precision="default",
                         grad=False, device="cpu")
    jp = j_ops.spmm_plan(jc, impl=impl, block_size=16, precision="default", grad=False)
    if impl == "bsr_pallas":
        assert tp.statics[0] == "flat" and jp.statics[-1] is None
        assert tp.arrays[2].dtype == torch.bfloat16
    else:
        assert tp.arrays[2].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp(x).numpy(), np.asarray(jp(x)))
    np.testing.assert_array_equal(tp(x).numpy(), want.astype(np.float32))


def _dist_cases():
    rng = np.random.default_rng(11)
    src = j_bsr.random_bsr(0.3, 12, 12, block_size=8, seed=11)
    ints = rng.integers(-16, 17, size=np.asarray(src.blocks).shape).astype(np.float32)
    jb = j_bsr.BSR.from_parts(np.asarray(src.block_rows), np.asarray(src.block_cols),
                              ints, tuple(src.shape), 8)
    x = rng.integers(-16, 17, size=(jb.shape[1], 16)).astype(np.float32)
    out = []
    for s in ("allgather", "ring"):
        for dt in (None, "bfloat16"):
            kw = {"strategy": s, "local_impl": "pallas", "precision": "default"}
            if dt:
                kw["dtype"] = dt
            out.append({"name": f"{s}_default_{dt or 'f32'}", "kind": "bsr", "jmat": jb,
                        "mat": port_bsr(jb), "x": x, "kw": kw, "mesh": "1d"})
    return out


DIST = {c["name"]: c for c in _dist_cases()}


@pytest.fixture(scope="module")
def dist_results():
    return world_results([{k: v for k, v in c.items() if k != "jmat"}
                          for c in DIST.values()], n=2)


@pytest.mark.parametrize("name", list(DIST))
def test_dist_bsr_default_matches_jax(dist_results, name):
    """On 2 gloo ranks the "default" stripes take JAX's layout tag (flat)
    and give, on integer blocks and operand, JAX's answer and float64's
    bit for bit (the stripes' plain versions and RowStripe too)."""
    case = DIST[name]
    check(dist_results, case, n=2)
    got = dist_results[name]["got"]
    np.testing.assert_array_equal(got, np.asarray(jax_plan(case, 2)(case["x"])))
    a = case["mat"].to_dense().astype(np.float64)
    np.testing.assert_array_equal(got, (a @ case["x"].astype(np.float64)).astype(np.float32))
