"""The distributed layer on the card: each stripe router
(``route_pallas_spmm``, ``route_pallas_int8_spmm``) against its plain
version on every layout it routes (flat through K1, K3 and the resident
K5 for a 2-byte operand; depth-sorted through K2, K3 and K7 with per-slot
and group scales; row groups through K4 and K8; int8 flat through K6) at
b = 16, 32 and 128, and a world of 2 ranks over gloo sharing the one GPU
(allgather and ring, f32 and int8) against spmm_scipy, the allgather's
exchange direct on the CUDA tensors and the ring's through the host, and
the rule that picks those transports (``exchange.transport``) against
what this torch's gloo does with CUDA tensors (all_gather, all_reduce,
reduce_scatter and send/recv), and the backward pass of every exchange
the training step crosses (the row all-gather, the shifts of the ring and
the halo, the feature all-gather, the loss's sum) on a world of 4 ranks
sharing the GPU, against its closed form. These need a GPU
and skip without one; run them on one with

    python -m pytest --noconftest tests/test_torch_cuda_parallel.py -q

(tests/conftest.py imports jax, which these tests do not need).

Tolerance: 1e-5 relative to max |plain| (the kernels' f32 sums run in
another order than the plain versions'); against spmm_scipy the tiers'
gates, 1e-4 for f32 and 6e-2 for int8."""

import numpy as np
import pytest
import torch

from spmm_denseblock_tpu_torch.formats.bsr import random_bsr
from spmm_denseblock_tpu_torch.ops import _kernels
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import route_pallas_spmm
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas_int8 import (
    quantize_int8,
    route_pallas_int8_spmm,
)
from spmm_denseblock_tpu_torch.parallel import shard as S
from spmm_denseblock_tpu_torch.parallel.spmm import _bucket_blocks

torch.set_num_threads(2)

# a string condition is evaluated when the test runs, not at import
pytestmark = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs an NVIDIA GPU: these tests hold the routers' kernels to "
           "their plain versions on the card",
)

TOL = 1e-5
DEV = "cuda"

# (layout, dtype, precision, kernel counter)
ROUTES = [
    ("flat", "f32", None, "bsr_spmm_flat"),
    ("flat", "f32", "high", "bsr_spmm_flat_bf16x3"),
    ("flat", "bf16", None, "bsr_spmm_resident_bf16"),
    ("flat", "bf16", "high", "bsr_spmm_flat_bf16"),
    ("sorted", "f32", None, "bsr_spmm_sorted"),
    ("sorted", "f32", "high", "bsr_spmm_sorted_bf16x3"),
    ("sorted", "bf16", None, "bsr_spmm_sorted_bf16"),
    ("rowgroup", "f32", None, "bsr_spmm_rowgroup"),
    ("rowgroup", "bf16", None, "bsr_spmm_rowgroup_bf16"),
    ("flat", "int8", None, "bsr_spmm_int8_flat"),
    ("rowgroup", "int8", None, "bsr_spmm_int8_rowgroup"),
    ("sorted", "int8", None, "bsr_spmm_int8_sorted"),
    ("sorted_gs", "int8", None, "bsr_spmm_int8_sorted"),
]


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


def _launches() -> dict:
    return {k.symbol.replace("sdb_", ""): k.launches for k in _kernels.KERNELS}


def _ring_bucket(b: int, layout: str, dtype: str):
    """One ring bucket (rank 1's blocks in chunk 2) of a 4-rank split of a
    random BSR, packed in `layout`, on the card: (router args, row_group,
    group, chunk rows)."""
    bsr = random_bsr(0.5 if layout.startswith("sorted") else 0.15, 24, 24,
                     block_size=b, seed=b)
    sh = S.shard_bsr(bsr, 4, payload=S.block_index_payload(bsr.nnzb))
    lr, cc, bv = S.bucket_by_col_chunk(sh)
    itemsize = {"f32": 4, "bf16": 2, "int8": 1}[dtype]
    if layout == "flat":
        rg, kw = 0, {}
    elif layout == "rowgroup":
        rg = 8 if itemsize == 1 else 16
        kw = {"rowgroup": rg}
    else:
        geom = (8, 8, 32) if itemsize == 1 else (16, 4, 128)
        rg = (layout if itemsize == 1 else "sorted",) + geom
        kw = {"sorted_geom": geom}
    lr, cc, bv, grp, walk = S.pack_buckets_pallas(lr, cc, bv, sh.rows_per_shard,
                                                 deep=itemsize < 4, **kw)
    sorted_form = isinstance(rg, tuple)
    R = rg[1] if sorted_form else (rg or 1)
    ptr = walk[1 if sorted_form else 0][1, 2]
    t = int(ptr[-1])
    srow = lr[1, 2]
    if sorted_form:
        T = srow.shape[0] // (1 + R)
        srow = np.concatenate([srow[:t], srow[T:T + t * R]])
    else:
        srow = srow[:t]
    idx = np.asarray(bv[1, 2])[..., 0, 0][: t * R * grp]
    dev = torch.device(DEV)
    blocks = _bucket_blocks(idx, np.asarray(bsr.blocks[: bsr.nnzb]), b,
                            None if dtype == "f32" else
                            {"bf16": "bfloat16", "int8": "int8"}[dtype],
                            None, rg, R, grp, t, dev)
    arrays = [torch.as_tensor(a, device=dev)
              for a in (srow, cc[1, 2][: t * R * grp], *blocks)]
    w = {"depth": int(walk[-1][1, 2])}
    if sorted_form:
        w["lane_valid"], w["ptr"], w["lane_order"] = (
            torch.as_tensor(walk[k][1, 2], device=dev) for k in range(3))
    else:
        w["ptr"], w["lane_order"] = (torch.as_tensor(walk[k][1, 2], device=dev)
                                     for k in range(2))
    return arrays, w, rg, grp, sh.rows_per_shard, sh.col_chunk * b


@pytest.mark.parametrize("b", [16, 32, 128])
@pytest.mark.parametrize("layout,dtype,precision,name", ROUTES)
def test_router_matches_plain(b, layout, dtype, precision, name):
    arrays, walk, rg, grp, nbr, k_rows = _ring_bucket(b, layout, dtype)
    F = 40
    x = torch.randn(k_rows, F, generator=torch.Generator().manual_seed(b)).to(DEV)
    if dtype == "int8":
        q, cs = quantize_int8(x, k_rows)
        args = (arrays[0], arrays[1], arrays[2], arrays[3], q, cs, nbr, nbr * b, walk,
                grp, rg)
        route = route_pallas_int8_spmm
    else:
        if dtype == "bf16":
            x = x.to(torch.bfloat16)
        blocks = arrays[2]
        if precision == "high" and dtype == "f32":
            from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import split_planes

            blocks = split_planes(blocks)
        args = (arrays[0], arrays[1], blocks, x, nbr, nbr * b, walk, grp, precision, rg)
        route = route_pallas_spmm
    before = _launches()[name]
    got = route(*args)
    if DEV == "cuda":
        torch.cuda.synchronize()
        assert _launches()[name] == before + 1
    want = route(*args, plain=True)
    assert got.shape == want.shape == (nbr * b, F)
    assert _rel(got, want) < TOL


def _world_case(rank: int, n: int, strategy: str, dtype: str) -> dict:
    from spmm_denseblock_tpu_torch.ops.reference import spmm_scipy
    from spmm_denseblock_tpu_torch.parallel import dist_bsr_spmm_plan, make_mesh_1d
    from spmm_denseblock_tpu_torch.parallel.exchange import (
        COUNTS,
        gather_output,
        transport,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    bsr = random_bsr(0.3, 20, 20, block_size=32, seed=5)
    x = np.random.default_rng(0).standard_normal((bsr.shape[1], 48)).astype(np.float32)
    mesh = make_mesh_1d(n)
    plan = dist_bsr_spmm_plan(bsr, mesh=mesh, strategy=strategy, local_impl="pallas",
                              dtype=None if dtype == "f32" else torch.int8)
    c = plan(torch.as_tensor(x, device="cuda"))
    assert c.is_cuda
    got = gather_output(plan, c).cpu().numpy()
    want = spmm_scipy(bsr, x)
    op = "send_recv" if strategy == "ring" else "all_gather"
    return {"rel": float(np.abs(got - want).max() / np.abs(want).max()),
            "transport": transport(mesh.get_group("row"), c.device, op),
            "host_round_trips": COUNTS["host_round_trips"]}


@pytest.mark.parametrize("strategy", ["allgather", "ring"])
@pytest.mark.parametrize("dtype,gate", [("f32", 1e-4), ("int8", 6e-2)])
def test_world_of_two_on_one_gpu(strategy, dtype, gate):
    from spmm_denseblock_tpu_torch.parallel.world import run_world

    _kernels.build()
    res = run_world(_world_case, 2, backend="gloo", args=(strategy, dtype),
                    timeout_s=300.0, threads=2)
    for r in res:
        # gloo gathers CUDA tensors itself; its send/recv take host copies
        if strategy == "ring":
            assert r["transport"] == "gloo via host" and r["host_round_trips"] > 0
        else:
            assert r["transport"] == "gloo direct" and r["host_round_trips"] == 0
        assert r["rel"] < gate, r


def _gloo_op_on_cuda(rank: int, n: int, op: str) -> bool:
    """One collective run directly on CUDA tensors over gloo: whether
    this rank got the right values."""
    import torch.distributed as dist

    x = torch.full((4,), float(rank), device=DEV)
    if op == "all_gather":
        got = torch.empty(4 * n, device=DEV)
        dist.all_gather_into_tensor(got, x)
        want = torch.arange(n).repeat_interleave(4).float()
    elif op == "all_reduce":
        got = x.clone()
        dist.all_reduce(got, op=dist.ReduceOp.MAX)
        want = torch.full((4,), float(n - 1))
    elif op == "reduce_scatter":
        src = torch.arange(4 * n, dtype=torch.float32, device=DEV) + rank
        got = torch.empty(4, device=DEV)
        dist.reduce_scatter_tensor(got, src)
        want = (torch.arange(4 * n, dtype=torch.float32) * n
                + n * (n - 1) / 2)[rank * 4:(rank + 1) * 4]
    else:
        got = torch.empty(4, device=DEV)
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, (rank + 1) % n),
                                         dist.P2POp(dist.irecv, got, (rank - 1) % n)]):
            w.wait()
        want = torch.full((4,), float((rank - 1) % n))
    return bool(torch.equal(got.cpu(), want))


@pytest.mark.parametrize("op", ["all_gather", "all_reduce", "reduce_scatter",
                                "send_recv"])
def test_gloo_takes_cuda_tensors(op):
    """exchange.transport's rule holds on this torch: the collectives it
    runs directly on CUDA tensors over gloo give the right values there,
    and the one it copies through the host (send/recv) does not (the
    world fails, or a rank gets wrong values)."""
    from spmm_denseblock_tpu_torch.parallel.exchange import _GLOO_CUDA_OPS
    from spmm_denseblock_tpu_torch.parallel.world import run_world

    try:
        res = run_world(_gloo_op_on_cuda, 2, backend="gloo", args=(op,),
                        timeout_s=60.0, threads=2)
    except RuntimeError as e:
        res = str(e)
    print(f"{op} on CUDA tensors over gloo, torch {torch.__version__}: {res}")
    assert (res == [True, True]) == (op in _GLOO_CUDA_OPS), res


@pytest.fixture(scope="module")
def exchange_grads():
    from spmm_denseblock_tpu_torch.parallel.world import run_world
    from torch_parallel_cases import exchange_grad_cases

    return run_world(exchange_grad_cases, 4, backend="gloo", args=(DEV,),
                     timeout_s=120.0, threads=2)


@pytest.mark.parametrize("name", ["all_gather_rows", "shift 1", "shift -2", "ring",
                                  "all_reduce_sum", "gather_columns"])
def test_exchange_backward_on_the_card(exchange_grads, name):
    """Each rank's autograd gradient through the exchange (gloo: the
    gathers and sums direct on the CUDA tensors, the shifts through the
    host) against the closed form, within 1e-6."""
    for got, want in (r[name] for r in exchange_grads):
        assert got.shape == want.shape
        assert _rel(got, want) < 1e-6
