"""The exchanges of the distributed plans, and the stripes they move.

Every distributed plan runs as SPMD over ``torch.distributed``: one
process a rank, the same host prep on every rank, and each rank keeps its
own stripe of the packed arrays on its own device. The JAX package runs
one program over a mesh with ``shard_map``; its collectives become the
functions below, each on the process group of one mesh axis:

- ``all_gather_rows``: JAX's tiled ``all_gather`` of B's row stripes;
- ``shift``: one ``ppermute`` step, posted as a send to rank me + k and a
  receive from rank me - k (``batch_isend_irecv``), waited on later, so
  that a caller can run a kernel while the bytes move;
- ``all_reduce_max``: the column absmax of an int8 operand's stripes;
- ``all_reduce_sum``: the training step's loss sums and gradients.

Training differentiates through them (``torch.autograd.Function``s):
the row all-gather's backward is a reduce-scatter over the same group
(each rank's stripe gets the sum of every rank's partial gradient of
it); a shift's backward is the reverse shift (the gradient of what a
rank received goes back to its sender, rank me - k); the sum's backward
is the identity (every rank computes the same loss from the same sum).
A ring's or halo's forward keeps its schedule: the exchange is posted
before the step's kernel, and the received tensor joins the graph when
it is waited on. The backward runs its collectives in the order of the
graph, the same on every rank, each posted and waited at once.

The transport follows the group's backend and the collective, never an
exception (``transport``): NCCL takes CUDA tensors; gloo takes CPU
tensors, and CUDA tensors for ``all_gather``, ``all_reduce`` and
``reduce_scatter``, but not for send/recv. (PyTorch's backend table
lists gloo's ``all_gather`` as CPU-only; with torch 2.11 on an H100 it
gathers, reduces and reduce-scatters CUDA tensors with the right values,
while a send of a CUDA tensor fails in gloo's TCP transport (``writev
...: Bad address`` on the sender, its peer's connection closed):
``tests/test_torch_cuda_parallel.py::test_gloo_takes_cuda_tensors``
holds this rule to the torch it runs on.) Where gloo cannot take a CUDA
tensor, the exchange copies it to the host, runs the collective there
and copies the result back: the ring and halo steps of several ranks
that share one GPU (NCCL refuses two ranks on one device) run that way.
``COUNTS`` counts, per process, the collectives, the bytes each rank
received and the host round trips of that path.

A stripe of the operand B is given by ``OperandSplit``: rank s holds
B's rows [lo[s], hi[s]), zero-padded to `chunk` rows, so that the n
padded stripes laid end to end are the JAX plan's padded B. A stripe of
C is given by ``DistInfo.out_rows``: the global rows a rank's output
holds, in order. ``RowStripe`` marks an operand that is already the
rank's own stripe (the JAX plans' "B may be passed with any sharding"):
a layer's output stripe then feeds the next layer with no gather.
``gather_output`` gathers C in caller order onto every rank.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

# per process: collectives run, bytes received, host round trips (gloo
# with CUDA tensors)
COUNTS = {"collectives": 0, "bytes_received": 0, "host_round_trips": 0}

# the collectives gloo takes CUDA tensors for (see the module docstring)
_GLOO_CUDA_OPS = ("all_gather", "all_reduce", "reduce_scatter")
# a backward shift's tags lie past the forward's
_BACKWARD_TAG = 1 << 16


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def transport(group, device, op: str = "all_gather") -> str:
    """"nccl", "gloo direct" or "gloo via host": how the collective `op`
    ("all_gather", "all_reduce", "reduce_scatter" or "send_recv") of a
    tensor on `device` runs on `group`."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        return "nccl"
    if (torch.device(device).type == "cuda" and backend == "gloo"
            and op not in _GLOO_CUDA_OPS):
        return "gloo via host"
    return f"{backend} direct"


def _via_host(group, t: torch.Tensor, op: str) -> bool:
    return transport(group, t.device, op) == "gloo via host"


def _all_gather_raw(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.contiguous()
    if n == 1:
        return x
    host = _via_host(group, x, "all_gather")
    src = x.cpu() if host else x
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    with warnings.catch_warnings():
        # torch 2.13 names it deprecated (for all_gather_single, which
        # older releases lack); it exists in every release the port runs
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, src, group=group)
    COUNTS["collectives"] += 1
    COUNTS["bytes_received"] += (n - 1) * x.numel() * x.element_size()
    if host:
        COUNTS["host_round_trips"] += 1
        return out.to(x.device)
    return out


def reduce_scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(n*c, F) on each of the group's n ranks -> (c, F): group rank s
    gets the sum over the ranks of rows [s*c, (s+1)*c), on x's device."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    if n == 1:
        return x
    host = _via_host(group, x, "reduce_scatter")
    src = x.cpu() if host else x
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)  # as all_gather's
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    COUNTS["collectives"] += 1
    COUNTS["bytes_received"] += (n - 1) * out.numel() * out.element_size()
    if host:
        COUNTS["host_round_trips"] += 1
        return out.to(x.device)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_rows(g, ctx.group), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(c, F) on each of the group's n ranks -> (n*c, F), in group rank
    order, on x's device. Its backward is reduce_scatter_rows."""
    if dist.get_world_size(group) == 1:
        return x.contiguous()
    return _AllGatherRows.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max of x over the group's ranks (a new tensor)."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    out = x.detach().clone()
    n = dist.get_world_size(group)
    if n == 1:
        return out
    host = _via_host(group, out, "all_reduce")
    buf = out.cpu() if host else out
    dist.all_reduce(buf, op=op, group=group)
    COUNTS["collectives"] += 1
    # a ring all-reduce: each rank receives 2 (n - 1) / n of the tensor
    COUNTS["bytes_received"] += 2 * (n - 1) * out.numel() * out.element_size() // n
    if host:
        COUNTS["host_round_trips"] += 1
        return buf.to(x.device)
    return buf


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise sum of x over the group's ranks (a new tensor). Its
    backward is the identity: every rank goes on from the same sum, so
    each rank's gradient of it is already the gradient of its own term."""
    return _AllReduceSum.apply(x, group)


class _ShiftGrad(torch.autograd.Function):
    """recv, the tensor a shift of x by k received, joined to x's graph:
    its gradient goes back to the sender by the reverse shift."""

    @staticmethod
    def forward(ctx, x, recv, group, k, tag):
        ctx.group, ctx.k, ctx.tag = group, k, tag
        return recv

    @staticmethod
    def backward(ctx, g):
        back = _post_shift(g, ctx.group, -ctx.k, _BACKWARD_TAG + ctx.tag).wait()
        return back, None, None, None, None


class _Pending:
    """A posted exchange: wait() returns the received tensor."""

    def __init__(self, works, recv, x, group, k, tag):
        self.works, self.recv, self.x = works, recv, x
        self.group, self.k, self.tag = group, k, tag

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        recv = self.recv.to(self.x.device)
        if torch.is_grad_enabled() and self.x.requires_grad:
            return _ShiftGrad.apply(self.x, recv, self.group, self.k, self.tag)
        return recv


class _Done:
    def __init__(self, t):
        self.t = t

    def wait(self) -> torch.Tensor:
        return self.t


def _post_shift(x: torch.Tensor, group, k: int, tag: int) -> _Pending:
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + k) % n)
    src = dist.get_global_rank(group, (me - k) % n)
    x = x.contiguous()
    host = _via_host(group, x, "send_recv")
    send = x.detach().cpu() if host else x.detach()
    recv = torch.empty_like(send)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dst, group, tag),
        dist.P2POp(dist.irecv, recv, src, group, tag),
    ])
    COUNTS["collectives"] += 1
    COUNTS["bytes_received"] += x.numel() * x.element_size()
    if host:
        COUNTS["host_round_trips"] += 1
    return _Pending(works, recv, x, group, k, tag)


def shift(x: torch.Tensor, group, k: int, tag: int = 0):
    """Post one ring step: send x to group rank (me + k) mod n and receive
    the same shape from (me - k) mod n. Returns a handle whose wait()
    gives the received tensor (x itself when k is 0 mod n); where x
    needs a gradient, the received tensor's flows back to x by the
    reverse shift."""
    if k % dist.get_world_size(group) == 0:
        return _Done(x)
    return _post_shift(x, group, k, tag)


@dataclasses.dataclass(frozen=True)
class OperandSplit:
    """Rank s holds B's rows [lo[s], hi[s]) zero-padded to `chunk` rows."""

    lo: Tuple[int, ...]
    hi: Tuple[int, ...]
    chunk: int

    @staticmethod
    def uniform(n: int, chunk: int, n_rows: int) -> "OperandSplit":
        lo = tuple(min(s * chunk, n_rows) for s in range(n))
        hi = tuple(min((s + 1) * chunk, n_rows) for s in range(n))
        return OperandSplit(lo, hi, chunk)

    @staticmethod
    def bounded(bounds, b: int, chunk: int, n_rows: int) -> "OperandSplit":
        """Variable contiguous stripes: stripe s covers block-rows
        bounds[s] .. bounds[s+1]-1 (balanced_contiguous_boundaries)."""
        n = len(bounds) - 1
        lo = tuple(min(int(bounds[s]) * b, n_rows) for s in range(n))
        hi = tuple(min(int(bounds[s + 1]) * b, n_rows) for s in range(n))
        return OperandSplit(lo, hi, chunk)


@dataclasses.dataclass(frozen=True, eq=False)
class RowStripe:
    """An operand that is already this rank's own stripe: rows
    [lo, hi) of B (``operand_rows(plan)``) and, on a mesh with a feature
    axis, the rank's slice of its columns; n_features is B's whole width
    (needed only with a feature axis)."""

    tensor: torch.Tensor
    n_features: Optional[int] = None


@dataclasses.dataclass(eq=False)
class DistInfo:
    """Where a rank's stripes lie. mesh: the plan's DeviceMesh; axis and
    feature_axis its axes; n the row ranks, me this rank's row index, tp
    the feature ranks, fj this rank's feature index. split: the operand's
    row stripes; out_rows[s]: the global rows of C that row rank s holds,
    in order, and out_pos[s] their positions in the rank's raw stripe
    output (None: the first len(out_rows[s]) rows)."""

    mesh: object
    axis: str
    feature_axis: Optional[str]
    n_rows: int
    n_cols: int
    split: OperandSplit
    out_rows: Tuple[np.ndarray, ...]
    out_pos: Optional[Tuple[np.ndarray, ...]]
    device: torch.device

    def __post_init__(self):
        coord = self.mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the plan's mesh")
        self.group = self.mesh.get_group(self.axis)
        self.n = self.mesh.size(self.mesh.mesh_dim_names.index(self.axis))
        self.me = self.mesh.get_local_rank(self.axis)
        if self.feature_axis is None:
            self.col_group, self.tp, self.fj = None, 1, 0
        else:
            self.col_group = self.mesh.get_group(self.feature_axis)
            self.tp = self.mesh.size(self.mesh.mesh_dim_names.index(self.feature_axis))
            self.fj = self.mesh.get_local_rank(self.feature_axis)
        self._pos = None

    def with_outputs(self, out_rows, out_pos) -> "DistInfo":
        return DistInfo(self.mesh, self.axis, self.feature_axis, self.n_rows,
                        self.n_cols, self.split, tuple(out_rows),
                        None if out_pos is None else tuple(out_pos), self.device)

    def feature_slice(self, F: int) -> Tuple[int, int, int]:
        """(fs, c0, c1): the padded slice width and this rank's real
        columns [c0, c1) of an F-wide operand."""
        fs = -(-F // self.tp)
        c0 = min(self.fj * fs, F)
        return fs, c0, min(c0 + fs, F)

    def operand_stripe(self, dense) -> Tuple[torch.Tensor, int]:
        """(this rank's stripe of B zero-padded to (chunk, fs), F) from
        the whole operand or a RowStripe, on the plan's device."""
        lo, hi = self.split.lo[self.me], self.split.hi[self.me]
        if isinstance(dense, RowStripe):
            x = torch.as_tensor(dense.tensor, device=self.device)
            if dense.n_features is not None:
                F = dense.n_features
            elif self.tp == 1:
                F = x.shape[1]
            else:
                raise ValueError("a RowStripe on a mesh with a feature axis needs "
                                 "n_features, the operand's whole width")
            fs, c0, c1 = self.feature_slice(F)
            if x.dim() != 2 or x.shape != (hi - lo, c1 - c0):
                raise ValueError(f"the operand stripe must be ({hi - lo}, {c1 - c0}) "
                                 f"(rows {lo}..{hi} of B), got {tuple(x.shape)}")
        else:
            x = torch.as_tensor(dense, device=self.device)
            if x.dim() != 2 or x.shape[0] != self.n_cols:
                raise ValueError(f"dense must be ({self.n_cols}, F), got "
                                 f"{tuple(x.shape)}")
            F = x.shape[1]
            fs, c0, c1 = self.feature_slice(F)
            x = x[lo:hi, c0:c1]
        pad_r, pad_c = self.split.chunk - x.shape[0], fs - x.shape[1]
        if pad_r or pad_c:
            x = torch.nn.functional.pad(x, (0, pad_c, 0, pad_r))
        return x.contiguous(), F

    def rows(self, raw: torch.Tensor) -> torch.Tensor:
        """The rows of this rank's raw stripe output that hold its rows of
        C (out_rows), in order."""
        if self.out_pos is None:
            return raw[: len(self.out_rows[self.me])]
        if self._pos is None:
            self._pos = torch.as_tensor(self.out_pos[self.me], device=raw.device)
        return raw.index_select(0, self._pos)

    def output(self, raw: torch.Tensor, F: int) -> torch.Tensor:
        """This rank's stripe of C from its raw stripe output: its rows
        and its real feature columns of an F-wide result."""
        _, c0, c1 = self.feature_slice(F)
        return self.rows(raw)[:, : c1 - c0]


def rank_device(device=None) -> torch.device:
    """A rank's device: `device` when given, else cuda:{rank % the
    visible GPUs}. Raises RuntimeError without a GPU rather than run on
    the CPU (CPU callers pass device="cpu")."""
    from spmm_denseblock_tpu_torch.ops._device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return dev


def dist_info(plan) -> DistInfo:
    """The DistInfo of a distributed plan (of the first part of a sum)."""
    while True:
        info = getattr(plan, "statics", None)
        if isinstance(info, tuple) and info and isinstance(info[0], DistInfo):
            return info[0]
        if plan.subplans is None:
            raise TypeError("not a distributed plan")
        plan = plan.subplans[0]


def output_rows(plan) -> np.ndarray:
    """The global rows of C that this rank's output holds, in order."""
    info = dist_info(plan)
    return info.out_rows[info.me]


def operand_rows(plan) -> Tuple[int, int]:
    """(lo, hi): the rows of B that this rank's RowStripe holds."""
    info = dist_info(plan)
    return info.split.lo[info.me], info.split.hi[info.me]


def assemble_rows(info: DistInfo, stripe: torch.Tensor, rows: Sequence[np.ndarray],
                  n_total: int) -> torch.Tensor:
    """Every row rank's stripe (rows[s] of a result of n_total rows)
    assembled on every rank, by one all_gather over the row group."""
    lens = [len(r) for r in rows]
    width = max(max(lens), 1)
    pad = torch.cat([stripe, stripe.new_zeros((width - stripe.shape[0],)
                                              + tuple(stripe.shape[1:]))])
    pieces = all_gather_rows(pad, info.group).reshape((info.n, width) + tuple(stripe.shape[1:]))
    out = torch.zeros((n_total,) + tuple(stripe.shape[1:]), dtype=stripe.dtype,
                      device=stripe.device)
    for s, r in enumerate(rows):
        if lens[s]:
            out[torch.as_tensor(r, device=out.device)] = pieces[s, : lens[s]]
    return out


def gather_columns(x: torch.Tensor, group, F: int) -> torch.Tensor:
    """The whole F columns of a result whose feature ranks (the group)
    each hold their feature slice (DistInfo.feature_slice), on every one
    of them, by one all_gather; its backward reduce-scatters."""
    tp = dist.get_world_size(group)
    if tp == 1:
        return x
    fs = -(-F // tp)
    padded = torch.nn.functional.pad(x, (0, fs - x.shape[1]))
    parts = all_gather_rows(padded, group).reshape(tp, x.shape[0], fs)
    return parts.permute(1, 0, 2).reshape(x.shape[0], tp * fs)[:, :F]


def gather_rows(info: DistInfo, stripe: torch.Tensor, rows: Sequence[np.ndarray],
                n_total: int) -> torch.Tensor:
    """Every row rank's stripe (rows[s] of a result of n_total rows)
    assembled on every rank, then every feature rank's columns."""
    out = assemble_rows(info, stripe, rows, n_total)
    if info.tp > 1:
        width = torch.tensor([out.shape[1]], device=out.device)
        F = int(all_reduce_sum(width, info.col_group).item())
        out = gather_columns(out, info.col_group, F)
    return out.contiguous()


def gather_output(plan, c: torch.Tensor) -> torch.Tensor:
    """The whole C (n_rows, F) in caller order on every rank, from each
    rank's output stripe c = plan(...): the analog of the JAX package's
    np.asarray(run(dense))."""
    info = dist_info(plan)
    return gather_rows(info, c, info.out_rows, info.n_rows)
