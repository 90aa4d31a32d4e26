"""JAX side of the distributed parity tests: each case's answer from the
JAX package's plan on the same mesh size (make_mesh_1d(n), n = 4 unless
the test's world is smaller, or make_mesh((2, 2)) for the "2d" cases),
with Pallas in interpret mode on
the 8-device CPU mesh of tests/conftest.py, as tests/test_parallel.py
runs it. The port's keyword arguments that stand for the JAX package's
SDB_* environment knobs are set as those knobs for the call."""

from __future__ import annotations

import os

import numpy as np

_MESHES = {}

# port keyword -> (JAX environment knob, its value for the keyword's value)
_ENV_KW = {"depth_sort": ("SDB_DEPTH_SORT", {True: "1", False: "0", None: "1"}),
           "group_scale": ("SDB_INT8_GROUP_SCALE", {True: "1", False: "0"})}


def jax_mesh(name: str, n: int = 4):
    from spmm_denseblock_tpu.parallel import make_mesh, make_mesh_1d

    if (name, n) not in _MESHES:
        _MESHES[(name, n)] = make_mesh_1d(n) if name == "1d" else make_mesh((2, 2))
    return _MESHES[(name, n)]


def jax_plan(case: dict, n: int = 4):
    import jax.numpy as jnp

    from spmm_denseblock_tpu.parallel import (
        dist_bsr_spmm_plan,
        dist_csr_spmm_plan,
        dist_hybrid_spmm_plan,
        dist_sddmm_plan,
        dist_windowed_spmm_plan,
    )

    build = {"bsr": dist_bsr_spmm_plan, "csr": dist_csr_spmm_plan,
             "hybrid": dist_hybrid_spmm_plan, "windowed": dist_windowed_spmm_plan,
             "sddmm": dist_sddmm_plan}[case["kind"]]
    kw = dict(case.get("kw", {}))
    if kw.get("dtype") is not None:
        kw["dtype"] = getattr(jnp, kw["dtype"])
    env = {}
    for key, (var, values) in _ENV_KW.items():
        if key in kw:
            env[var] = values[kw.pop(key)]
    saved = {var: os.environ.get(var) for var in env}
    os.environ.update(env)
    try:
        return build(case["jmat"], mesh=jax_mesh(case.get("mesh", "1d"), n), **kw)
    finally:
        for var, v in saved.items():
            if v is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = v


def jax_layout_tag(plan):
    """The last static of the JAX BSR plan's inner tuple (the LPT wrapper
    unwrapped)."""
    while not plan.statics:
        plan = plan.arrays[0]
    return plan.statics[1][-1]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def check(results: dict, case: dict, tol: float = 1e-5, n: int = 4) -> None:
    """The port's gathered C (rank 0's) against the JAX plan's on n
    devices: a port Plan whose buffers lie on the rank's device, its
    answer through the whole operand, a RowStripe and the plain versions
    the same, within `tol` of JAX's (relative to max |JAX|); the layout
    tag first."""
    res = results[case["name"]]
    assert "error" not in res, res["error"]
    if case.get("raises"):
        import pytest

        assert res["raised"] == case["raises"], res
        with pytest.raises(Exception) as err:
            jax_plan(case, n)
        assert type(err.value).__name__ == case["raises"]
        return
    assert res["is_plan"] and res["devices"] == ["cpu"] and res["n_buffers"] > 0
    if case["kind"] != "sddmm":
        assert res["plain_equal"]
        assert res.get("stripe_equal", True)
    if "strategy" in res:  # plan_strategy names the plan's own strategy
        assert res["plan_strategy"].split(" (")[0] == res["strategy"], res
    plan = jax_plan(case, n)
    if "tag" in res:
        assert res["tag"] == jax_layout_tag(plan)
    want = (np.asarray(plan(case["x"], case["y"])) if case["kind"] == "sddmm"
            else np.asarray(plan(case["x"])))
    assert res["got"].shape == want.shape
    assert rel(res["got"], want) < tol, rel(res["got"], want)
