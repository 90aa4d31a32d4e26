"""The port's communication-volume model (parallel/comms.py) against the
JAX package's, and parallel.multihost in a world of 2 CPU ranks."""

import numpy as np
import pytest

import spmm_denseblock_tpu.parallel.comms as JC
import spmm_denseblock_tpu_torch.parallel.comms as TC
from spmm_denseblock_tpu_torch.utils.profiling import HBM_BYTES_S, PEAK_OPS_S
from torch_parallel_cases import multihost_case

V5E_AS_PORT = TC.ChipModel(
    name=JC.V5E.name, peak_flops_f32=JC.V5E.peak_flops_f32,
    peak_flops_bf16=JC.V5E.peak_flops_bf16, hbm_gbps=JC.V5E.hbm_gbps,
    link_gbps=JC.V5E.ici_gbps, mfu=JC.V5E.mfu)

CASES = [(s, n, halo) for s in ("allgather", "ring", "halo") for n in (1, 2, 4, 8, 64)
         for halo in (1, 2)]


@pytest.mark.parametrize("strategy,n,halo", CASES)
def test_comms_model_matches_jax(strategy, n, halo):
    """The formulas unchanged: under JAX's v5e fields every number is
    JAX's."""
    K, F, nnzb, b = 1 << 17, 512, 20668, 128
    for itemsize in (4, 2, 1):
        assert TC.comms_bytes_per_device(strategy, n, K, F, itemsize, halo) == \
            JC.comms_bytes_per_device(strategy, n, K, F, itemsize, halo)
        for dt in ("f32", "bf16"):
            for overlap in (True, False):
                want = JC.efficiency_model(strategy, n, nnzb, b, K, F, itemsize, halo,
                                           JC.V5E, dt, overlap)
                got = TC.efficiency_model(strategy, n, nnzb, b, K, F, itemsize, halo,
                                          V5E_AS_PORT, dt, overlap)
                assert got == want
            for target in (0.5, 0.8, 1.0):
                assert TC.min_nnzb_for_efficiency(
                    strategy, n, b, K, F, target, itemsize, halo, V5E_AS_PORT, dt
                ) == JC.min_nnzb_for_efficiency(
                    strategy, n, b, K, F, target, itemsize, halo, JC.V5E, dt)


def test_comms_model_shape():
    """Halo is O(1) in the ranks, allgather and ring (n-1)/n; efficiency
    reaches 1.0 once per-rank compute covers the exchange; min_nnzb
    inverts the model; an unknown strategy raises."""
    K, F = 1 << 17, 512
    full = K * F * 4
    assert TC.comms_bytes_per_device("allgather", 8, K, F) == 7 / 8 * full
    assert TC.comms_bytes_per_device("halo", 64, K, F) == 2 / 64 * full
    nnzb = TC.min_nnzb_for_efficiency("ring", 4, 128, K, F, target=1.0)
    assert TC.efficiency_model("ring", 4, nnzb, 128, K, F)["efficiency"] == 1.0
    assert TC.efficiency_model("ring", 4, nnzb // 2, 128, K, F)["efficiency"] < 1.0
    with pytest.raises(ValueError):
        TC.comms_bytes_per_device("tree", 4, K, F)


def test_default_model_is_the_h100():
    chip = TC.ChipModel()
    assert chip == TC.H100 and "h100" in chip.name
    assert chip.peak_flops_f32 == PEAK_OPS_S["f32"] == 67e12
    assert chip.peak_flops_bf16 == PEAK_OPS_S["bf16"] == 989e12
    assert chip.hbm_gbps == HBM_BYTES_S == 3.35e12
    assert chip.link_gbps == 450e9 and chip.mfu == 0.56
    assert "v5e" not in chip.name and not hasattr(chip, "ici_gbps")
    assert TC.efficiency_model("allgather", 4, 20668, 128, 1 << 17, 512)["chip"] == chip.name


@pytest.fixture(scope="module")
def multihost(tmp_path_factory):
    from spmm_denseblock_tpu_torch.parallel.world import run_world

    store = tmp_path_factory.mktemp("multihost") / "store"
    return run_world(multihost_case, 2, backend=None, args=(str(store),),
                     timeout_s=120.0)


def test_multihost_initialize_twice_is_a_noop(multihost):
    for r in multihost:
        assert r["same_group"] and r["world"] == 2


def test_multihost_pod_mesh(multihost):
    """As JAX's pod_mesh: (world, 1) by default, (rows, world // rows)
    with row_parallelism, axes ("row", "col"), and a ValueError when the
    world does not divide."""
    from spmm_denseblock_tpu.parallel.multihost import pod_mesh

    for r in multihost:
        assert r["pod_shape"] == (2, 1) and r["pod_names"] == ("row", "col")
        assert r["rows_1"] == (1, 2)
        assert r["refused"] == "2 devices not divisible by row_parallelism=3"
    with pytest.raises(ValueError, match="not divisible by row_parallelism=3"):
        pod_mesh(3)  # JAX's, on the 8 CPU devices
    assert tuple(pod_mesh().devices.shape) == (8, 1)


def test_multihost_is_coordinator(multihost):
    assert [r["coordinator"] for r in multihost] == [True, False]
