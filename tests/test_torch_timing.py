"""The port's timers (bench/timing) on the CPU: _mix perturbs every input
it is given, as JAX's does (the 1e-30 underflow regression); each timed
call's input is made from the previous call's output; time_repeats' record has JAX's
fields and median, min, max and spread_frac; and spread_warn follows the
largest |v - median| / median, not JAX's min-max band. The port fixes the
JAX module's over-flagged spread (bench/timing.py:111): a band that
widens with every repeat flags records whose repeats all lie within 10%
of their median, and the port's does not. The CUDA-event paths run in
test_torch_cuda_kernels.py."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

JT = importlib.import_module("spmm_denseblock_tpu.bench.timing")
TT = importlib.import_module("spmm_denseblock_tpu_torch.bench.timing")

torch.set_num_threads(2)


def test_timing_mix_produces_distinct_chain_inputs():
    """eps * sum(y) must not underflow: with sum(y) = 4096 the shift is
    ~4e-9, which moves the small entries of x, as in JAX."""
    x = np.linspace(-2, 2, 4096, dtype=np.float32).reshape(32, 128)
    y = np.ones((32, 128), np.float32)
    out = TT._mix(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    assert not np.array_equal(out, x)
    np.testing.assert_array_equal(out, np.asarray(JT._mix(jnp.asarray(x),
                                                          jnp.asarray(y))))


@pytest.mark.parametrize("timer", ["time_chained", "time_chained_square",
                                   "time_synced"])
def test_every_call_gets_a_new_input(timer):
    """Each timed call's input is made from the previous call's output:
    an fn whose output changes with every call sees a new input every
    time."""
    seen = []

    def fn(x):
        seen.append(x.clone())
        return x * 0 + 1e6 * len(seen)

    x0 = torch.as_tensor(np.random.default_rng(0).standard_normal((32, 64)),
                         dtype=torch.float32)
    secs = getattr(TT, timer)(fn, x0, iters=5)
    assert secs > 0
    timed = seen[-5:]
    assert len(seen) > 5 and not any(torch.equal(timed[i], timed[j])
                                     for i in range(5) for j in range(i))


def _scripted(monkeypatch, vals):
    """Both packages' chained timers return `vals` in turn."""
    for mod in (JT, TT):
        it = iter(vals)
        for name in ("time_chained", "time_chained_square"):
            monkeypatch.setattr(mod, name, lambda fn, x0, iters=10, k=6, _i=it: next(_i))


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("vals,want", [
    ([3e-3, 1e-3, 2e-3], (2e-3, 1e-3, 3e-3)),
    ([1.0, 4.0, 2.0, 3.0], (2.5, 1.0, 4.0)),
    ([5e-4], (5e-4, 5e-4, 5e-4)),
])
def test_time_repeats_fields(vals, want, square, monkeypatch):
    _scripted(monkeypatch, vals + vals)
    rec = TT.time_repeats(None, None, repeats=len(vals), square=square)
    j_rec = JT.time_repeats(None, None, repeats=len(vals), square=square)
    assert (rec["secs"], rec["secs_min"], rec["secs_max"]) == want
    assert rec["repeats"] == len(vals)
    for k in ("secs", "secs_min", "secs_max", "repeats", "spread_frac"):
        assert rec[k] == j_rec[k], k


@pytest.mark.parametrize("vals,jax_flags,port_flags", [
    # within 6% of the median: JAX's band is 12% and flags, the port does not
    ([0.94, 1.0, 1.06], True, False),
    # nine repeats, each within 8% of the median: a band of 16%
    ([0.92, 0.95, 0.97, 0.99, 1.0, 1.01, 1.03, 1.05, 1.08], True, False),
    # one repeat 20% off: both flag
    ([1.0, 1.0, 1.2], True, True),
    ([0.85, 1.0, 1.01], True, True),
    # tight: neither flags
    ([0.99, 1.0, 1.02], False, False),
])
def test_spread_warn_is_robust(vals, jax_flags, port_flags, monkeypatch):
    _scripted(monkeypatch, vals + vals)
    j_rec = JT.time_repeats(None, None, repeats=len(vals))
    rec = TT.time_repeats(None, None, repeats=len(vals))
    assert j_rec.get("spread_warn", False) is jax_flags
    assert rec.get("spread_warn", False) is port_flags
    assert rec["spread_frac"] == j_rec["spread_frac"]


def test_cpu_timers_take_numpy_operands():
    x = np.ones((16, 8), np.float32)
    assert TT.time_chained(lambda v: v * 2.0, x, iters=3) > 0
    assert TT.time_synced(lambda v: v.sum(0), x, iters=3) > 0
