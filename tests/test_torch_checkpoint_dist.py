"""Sharded checkpoints of the port (models/checkpoint_dist.py, on
torch.distributed.checkpoint) on one world of 4 CPU ranks over gloo
(module fixture): the round trip of DTensor shards on a (2, 2) mesh, bit
for bit, each into the template's placement and in place, each rank
writing its own shards only; retention and the latest step; a missing
step raising FileNotFoundError; and training resumed from a checkpoint
bit-identical to training that went on (GIN on (2, 2) with synchronous
saves, GCN on (4, 1) with async ones). The JAX package's orbax manager,
on a (2, 2) mesh over 4 of conftest's 8 CPU devices, keeps the same
steps and raises the same error (its files are not the port's: the
parity is of behaviour)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from spmm_denseblock_tpu.models.checkpoint_dist import (
    make_manager,
    restore_dist_checkpoint,
    save_dist_checkpoint,
)
from spmm_denseblock_tpu.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from spmm_denseblock_tpu_torch.parallel.world import run_world
    from torch_parallel_cases import checkpoint_cases

    root = str(tmp_path_factory.mktemp("ckpt"))
    return run_world(checkpoint_cases, 4, args=(root,), timeout_s=240.0)


def test_sharded_roundtrip(results):
    for rank, res in enumerate(results):
        rt = res["roundtrip"]
        assert rt["step"] == 5
        assert rt["w_equal"] and rt["mu_equal"] and rt["b_equal"], rt
        assert rt["placements"] and rt["in_place"], rt
    files = results[0]["roundtrip"]["file_bytes"]
    # one file a rank; none holds a whole w: each rank wrote its shards
    assert sorted(files) == [f"__{r}_0.distcp" for r in range(4)]
    whole = results[0]["roundtrip"]["whole_w_bytes"]
    assert all(b < whole for b in files.values()), files
    assert sum(files.values()) >= 2 * whole  # w and mu, every shard once


def test_retention_and_latest(results):
    for res in results:
        ret = res["retention"]
        assert ret["latest"] == 3 and ret["steps"] == [2, 3], ret
        assert ret["restored"] == 3 and ret["restored_2"] == 2 and ret["w2_equal"], ret


def test_restore_missing_raises(results):
    for res in results:
        assert res["missing"] == [("empty", "FileNotFoundError"),
                                  ("absent step", "FileNotFoundError")]


@pytest.mark.parametrize("case", ["resume_gin_2x2", "resume_gcn_4x1_async"])
def test_resume_is_bit_exact(results, case):
    for res in results:
        r = res[case]
        assert r["step"] == 2 and r["steps"] == [1, 2], r
        assert r["loss_equal"] and r["params_equal"], r


def test_jax_manager_keeps_the_same_steps(results, tmp_path):
    """orbax on the same mesh shape: the same retained steps and latest
    step as the port's, and the same error for a directory with none."""
    mesh = make_mesh((2, 2), devices=jax.devices()[:4])
    w = jax.device_put(np.arange(64 * 16, dtype=np.float32).reshape(64, 16),
                       NamedSharding(mesh, P("row", "col")))
    state = {"params": {"w": w, "b": jnp.zeros(16)}}
    mgr = make_manager(str(tmp_path / "j"), max_to_keep=2)
    for s in (1, 2, 3):
        save_dist_checkpoint(mgr, s, state)
    ret = results[0]["retention"]
    assert mgr.latest_step() == ret["latest"]
    assert sorted(mgr.all_steps()) == ret["steps"]
    with pytest.raises(FileNotFoundError):
        restore_dist_checkpoint(make_manager(str(tmp_path / "none")), state)
