"""The CSR half of the port's distributed plans (parallel/spmm.py) held
to the JAX package's: the row-partitioned ELL tier (plain, hub rows,
compacted, bf16 and int8 gathers, calibrated), the segment tier, the
hybrid (f32, bf16 remainder, int8, ring dense part), the windowed tier
(f32, int8) and SDDMM in global edge order; plus the ELL stripes'
layout arrays, bit for bit. One world of 4 CPU ranks over gloo runs
every case (module fixture)."""

import numpy as np
import pytest
import torch

from spmm_denseblock_tpu.convert.divide import divide
from spmm_denseblock_tpu.formats.csr import CSR, random_csr
from spmm_denseblock_tpu.formats.windowed import divide_windowed
from spmm_denseblock_tpu.reorder import permutate
from torch_parallel_cases import port_csr, port_hybrid, port_windowed, world_results
from torch_parallel_jax import check

torch.set_num_threads(1)


def _x(n_rows, f, seed):
    return np.random.default_rng(seed).standard_normal((n_rows, f)).astype(np.float32)


def hub_csr():
    """Two hub rows, so the stripes' degree classes differ."""
    csr = random_csr(0.03, 300, 200, seed=5)
    s = csr.to_scipy().tolil()
    s[0, :150] = 1.5
    s[299, ::2] = -0.5
    return CSR.from_scipy(s.tocsr())


def banded_noise():
    n = 176
    rows = np.repeat(np.arange(n), 4)
    cols = (rows + np.tile(np.arange(4), n)) % n
    noise_r = np.arange(0, n, 7)
    noise_c = (noise_r * 13 + 5) % n
    return CSR.from_coo(np.concatenate([rows, noise_r]),
                        np.concatenate([cols, noise_c]), None, (n, n))


def _case(name, kind, jm, f, seed, **kw):
    port = {"csr": port_csr, "hybrid": port_hybrid, "windowed": port_windowed,
            "sddmm": port_csr}[kind]
    return {"name": name, "kind": kind, "jmat": jm, "mat": port(jm),
            "x": _x(jm.shape[1], f, seed), "kw": kw}


def _cases():
    hub = hub_csr()
    pattern = random_csr(0.04, 280, 190, seed=9)
    pattern = CSR(indptr=pattern.indptr, indices=pattern.indices, data=None,
                  shape=pattern.shape)
    valued = random_csr(0.04, 280, 190, seed=9)
    g = random_csr(0.05, 256, 256, seed=3)
    hyb = divide(g, 16, 0.05)
    hyb_ones = divide(random_csr(0.04, 320, 256, seed=13, values="ones"), 16, 0.05)
    wt = divide_windowed(banded_noise(), tile_rows=8, window=16)
    wt_i8 = divide_windowed(g, tile_rows=16, window=32)
    cal = _x(1600, 16, 98)
    perm = np.random.default_rng(3).permutation(96)
    out = [
        _case("ell_basic", "csr", random_csr(0.03, 300, 200, seed=5), 17, 1),
        _case("ell_hub_rows", "csr", hub, 17, 2),
        _case("segment_hub_rows", "csr", hub, 17, 2, impl="segment"),
        _case("ell_compact_valued", "csr", valued, 9, 3, compact="force",
              compact_slots=128),
        _case("ell_compact_pattern", "csr", pattern, 9, 3, compact="force",
              compact_slots=128),
        _case("ell_compact_auto", "csr", valued, 9, 3, compact="auto"),
        _case("ell_bf16", "csr", random_csr(0.05, 256, 192, seed=9), 16, 4,
              dtype="bfloat16"),
        _case("ell_permuted", "csr", permutate(perm, random_csr(0.05, 96, 96, seed=17,
                                                                values="ones")), 12, 5),
        _case("hybrid_f32", "hybrid", hyb_ones, 24, 6),
        _case("hybrid_ring", "hybrid", hyb_ones, 24, 6, strategy="ring"),
        _case("hybrid_bf16", "hybrid", hyb, 16, 7, dtype="bfloat16"),
        _case("hybrid_int8", "hybrid", hyb, 16, 8, dtype="int8"),
        _case("hybrid_int8_calibrated", "hybrid", hyb, 16, 8, dtype="int8",
              calibration=cal),
        _case("windowed_f32", "windowed", wt, 12, 9),
        _case("windowed_bf16", "windowed", wt, 12, 9, dtype="bfloat16"),
        _case("windowed_int8", "windowed", wt_i8, 16, 10, dtype="int8"),
        _case("windowed_int8_calibrated", "windowed", wt_i8, 16, 10, dtype="int8",
              calibration=cal),
    ]
    for values in ("random", "ones"):
        m = random_csr(0.05, 256, 192, seed=9, values=values)
        out += [_case(f"ell_int8_{values}", "csr", m, 16, 11, dtype="int8"),
                _case(f"ell_int8_{values}_calibrated", "csr", m, 16, 11, dtype="int8",
                      calibration=cal)]
    sd = random_csr(0.06, 100, 72, seed=21)
    c = _case("sddmm", "sddmm", sd, 9, 12)
    c["x"], c["y"] = _x(100, 9, 12), _x(72, 9, 13)
    out.append(c)
    out.append({**_case("ell_rejects_calibration_without_int8", "csr", hub, 17, 2,
                        calibration=cal[:, :17]), "raises": "ValueError"})
    return out


CASES = {c["name"]: c for c in _cases()}


@pytest.fixture(scope="module")
def results():
    return world_results([{k: v for k, v in c.items() if k != "jmat"}
                          for c in CASES.values()])


@pytest.mark.parametrize("name", list(CASES))
def test_dist_csr_matches_jax(results, name):
    check(results, CASES[name])
