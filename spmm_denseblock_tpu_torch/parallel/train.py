"""Distributed end-to-end GNN training step over a 2D ("row", "col") mesh
(twin of ``spmm_denseblock_tpu/parallel/train.py``), SPMD over
``torch.distributed``: one process a rank, each with its own stripes.

Parallelism map (the JAX package's):
  "row" - graph nodes: A's block-row stripes and the rows of X, H, the
          logits, the labels and the mask. The SpMM's exchange runs here.
  "col" - tensor parallelism: the feature dims of X and H, and the
          output dim of every weight and bias whose width divides the
          col size.

The JAX package leaves the dense layers to GSPMD. Here each step is
explicit, and every collective it crosses is differentiable
(``parallel/exchange.py``):
- a rank holds its rows of every activation (``output_rows(plan)``: the
  rows its SpMM stripe writes) and its feature slice
  (``DistInfo.feature_slice``);
- the SpMM takes its operand at the plan's operand rows. Where those
  differ from the output rows (LPT balancing permutes them), one
  all_gather over the row group assembles the rows; its backward is a
  reduce-scatter. The hybrid's plan has no feature axis, so on a 2D mesh
  its operand's columns are gathered first and the result sliced;
- a dense layer gathers its input's feature slices over col (backward:
  a reduce-scatter) and multiplies by its weight's column slice; a
  replicated weight computes every column and keeps the rank's slice;
- the loss gathers the logits' columns (each rank's gradient is its own
  slice of the same loss's) and sums the masked cross-entropy, sum(mask)
  and the hits over the row group: every rank has the same loss;
- gradients: every leaf's is summed over the row group (each rank's rows
  add a share); a replicated leaf's also over col (each col rank used it
  on its own slice only). Then ``torch.optim`` updates each rank's
  shards in place; the replicas stay equal.

The local stripe product is the "xla" one (torch ops, differentiable),
as in the JAX step.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from spmm_denseblock_tpu_torch.convert.csr2bsr import csr_to_bsr
from spmm_denseblock_tpu_torch.formats.bsr import BSR
from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.formats.hybrid import Hybrid
from spmm_denseblock_tpu_torch.models.checkpoint import tree_leaves, tree_map, tree_unflatten
from spmm_denseblock_tpu_torch.models.gnn import MODELS
from spmm_denseblock_tpu_torch.parallel import exchange as exch
from spmm_denseblock_tpu_torch.parallel.exchange import RowStripe, rank_device
from spmm_denseblock_tpu_torch.parallel.spmm import dist_bsr_spmm_plan, dist_hybrid_spmm_plan


def _col_axis(mesh) -> Optional[str]:
    names = mesh.mesh_dim_names
    if len(names) > 1 and mesh.size(1) > 1:
        return names[1]
    return None


def _col_sharded(shape, n_col: int) -> bool:
    """JAX's rule: a leaf's last dim goes over col where it divides the
    col size; 0-d leaves and the rest stay replicated."""
    return n_col > 1 and len(shape) > 0 and shape[-1] % n_col == 0


def _shard_params(params, mesh, col_axis: Optional[str], device=None):
    """This rank's shards of a whole parameter tree (numpy arrays or
    tensors, float32): each leaf's last dim over col where it divides
    the col size (the weights' output dim, the biases), else the leaf."""
    n_col = mesh.size(mesh.mesh_dim_names.index(col_axis)) if col_axis else 1
    fj = mesh.get_local_rank(col_axis) if col_axis else 0

    def put(leaf):
        t = (leaf.detach() if torch.is_tensor(leaf) else torch.as_tensor(np.asarray(leaf)))
        if _col_sharded(t.shape, n_col):
            w = t.shape[-1] // n_col
            t = t[..., fj * w:(fj + 1) * w]
        return t.to(device=device, dtype=torch.float32).contiguous().clone()

    return tree_map(put, params)


class DistTrainStep:
    """step(params, opt_state, x, y, mask) -> (params, opt_state, metrics):
    one training step of this rank, from the whole x, y and mask on every
    rank (numpy arrays or tensors). The parameters are updated in place;
    metrics hold the global "loss" and "acc" (the same on every rank,
    taken before the update) and "exchange_bytes", the bytes this rank
    received in the forward pass, the backward pass and the gradients'
    sums. After a step each parameter's .grad holds its summed gradient.

    plan: the distributed SpMM plan; mesh: its DeviceMesh; sharded: per
    parameter leaf (JAX's leaf order) whether it is split over col."""

    def __init__(self, plan, mesh, col_axis, apply_fn: Callable, sharded: List[bool],
                 dims: Sequence[int], device: torch.device):
        self.plan, self.mesh, self.apply_fn = plan, mesh, apply_fn
        self.sharded, self.dims, self.device = list(sharded), list(dims), device
        self.info = exch.dist_info(plan)
        if col_axis is None:
            self.col_group, self.tp, self.fj = None, 1, 0
        else:
            self.col_group = mesh.get_group(col_axis)
            self.tp = mesh.size(mesh.mesh_dim_names.index(col_axis))
            self.fj = mesh.get_local_rank(col_axis)
        # the plan splits the operand's columns itself (a BSR plan with the
        # feature axis) or takes them whole (the hybrid)
        self.feature_plan = self.info.tp > 1
        rows = exch.output_rows(plan)
        self.rows = torch.as_tensor(rows, dtype=torch.int64)
        lo, hi = exch.operand_rows(plan)
        self.chained = bool(np.array_equal(rows, np.arange(lo, hi)))
        self._is_sharded = {}

    # -- layout -----------------------------------------------------------

    def feature_slice(self, F: int):
        fs = -(-F // self.tp)
        c0 = min(self.fj * fs, F)
        return c0, min(c0 + fs, F)

    def _cut(self, a, F: Optional[int] = None) -> torch.Tensor:
        """This rank's rows (and with F, its feature slice of F columns)
        of a whole array, on the rank's device."""
        t = torch.as_tensor(a)
        t = t.index_select(0, self.rows.to(t.device))
        if F is not None:
            c0, c1 = self.feature_slice(F)
            t = t[:, c0:c1]
        return t.to(self.device)

    def _width(self, h: torch.Tensor) -> int:
        """The whole width of an activation whose feature slices the col
        ranks hold."""
        if self.tp == 1:
            return h.shape[1]
        w = torch.tensor([h.shape[1]], dtype=torch.float32, device=h.device)
        return int(exch.all_reduce_sum(w, self.col_group).item())

    def _to_operand(self, h: torch.Tensor) -> torch.Tensor:
        """h (this rank's output rows) at the plan's operand rows."""
        if self.chained:
            return h
        info = self.info
        full = exch.assemble_rows(info, h, info.out_rows, info.n_rows)
        lo, hi = info.split.lo[info.me], info.split.hi[info.me]
        return full[lo:hi]

    def _gather_cols(self, h: torch.Tensor, F: int) -> torch.Tensor:
        return h if self.tp == 1 else exch.gather_columns(h, self.col_group, F)

    # -- the model's pieces -----------------------------------------------

    def spmm(self, h: torch.Tensor) -> torch.Tensor:
        F = self._width(h)
        if self.feature_plan:
            return self.plan(RowStripe(self._to_operand(h), n_features=F))
        out = self.plan(RowStripe(self._to_operand(self._gather_cols(h, F))))
        if self.tp > 1:
            c0, c1 = self.feature_slice(F)
            out = out[:, c0:c1]
        return out

    def dense(self, p: dict, h: torch.Tensor) -> torch.Tensor:
        w = p["w"]
        out = torch.matmul(self._gather_cols(h, w.shape[0]), w) + p["b"]
        if self.tp > 1 and not self._is_sharded[id(w)]:
            c0, c1 = self.feature_slice(w.shape[1])
            out = out[:, c0:c1]
        return out

    def loss(self, logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor):
        """(the global masked cross-entropy, the global accuracy)."""
        C = self.dims[-1]
        if self.tp > 1:
            # every col rank goes on with the same whole logits: its
            # gradient is its own columns' (no sum over col)
            with torch.no_grad():
                whole = exch.gather_columns(logits, self.col_group, C)
            c0, c1 = self.feature_slice(C)
            logits = torch.cat([whole[:, :c0], logits, whole[:, c1:]], dim=1)
        logp = torch.log_softmax(logits, dim=-1)
        per_node = -logp.gather(-1, y.long()[:, None])[:, 0]
        w = mask.to(logits.dtype)
        hits = ((logits.argmax(dim=-1) == y).to(torch.float32) * w).sum().detach()
        sums = exch.all_reduce_sum(
            torch.stack([(per_node * w).sum(), w.sum().detach(), hits]), self.info.group)
        den = torch.clamp(sums[1], min=1.0)
        return sums[0] / den, (sums[2] / den).detach()

    def _reduce_grads(self, leaves) -> None:
        grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in leaves]
        with torch.no_grad():
            for group, pick in ((self.info.group, [True] * len(leaves)),
                                (self.col_group, [not s for s in self.sharded])):
                if group is None or torch.distributed.get_world_size(group) == 1:
                    continue
                idx = [i for i, p in enumerate(pick) if p]
                if not idx:
                    continue
                flat = exch.all_reduce_sum(
                    torch.cat([grads[i].reshape(-1) for i in idx]), group)
                for i, g in zip(idx, flat.split([grads[i].numel() for i in idx])):
                    grads[i] = g.reshape(grads[i].shape)
        for t, g in zip(leaves, grads):
            t.grad = g

    # -- the step ---------------------------------------------------------

    def __call__(self, params, opt_state, x, y, mask):
        leaves = tree_leaves(params)
        self._is_sharded = {id(t): s for t, s in zip(leaves, self.sharded)}
        x, y, mask = self._cut(x, self.dims[0]), self._cut(y), self._cut(mask)
        opt_state.zero_grad(set_to_none=True)
        b0 = exch.COUNTS["bytes_received"]
        logits = self.apply_fn(params, self.spmm, x, dense=self.dense)
        loss, acc = self.loss(logits, y, mask)
        b1 = exch.COUNTS["bytes_received"]
        loss.backward()
        b2 = exch.COUNTS["bytes_received"]
        self._reduce_grads(leaves)
        b3 = exch.COUNTS["bytes_received"]
        opt_state.step()
        return params, opt_state, {
            "loss": loss.detach(), "acc": acc,
            "exchange_bytes": {"forward": b1 - b0, "backward": b2 - b1, "grads": b3 - b2}}

    # -- whole trees and checkpoints --------------------------------------

    def whole(self, tree):
        """A tree of this step's parameter structure (the parameters, or
        their gradients: tree_map(lambda t: t.grad, params)) with every
        col-sharded leaf gathered whole, on every rank (detached)."""
        out = []
        for t, s in zip(tree_leaves(tree), self.sharded):
            t = t.detach()
            if s and self.tp > 1:
                parts = exch.all_gather_rows(t.movedim(-1, 0).contiguous(), self.col_group)
                t = parts.movedim(0, -1)
            out.append(t)
        return tree_unflatten(tree, out)

    def placements(self, params) -> list:
        """Each parameter leaf's DTensor placements on the mesh."""
        from torch.distributed.tensor import Replicate, Shard

        names = self.mesh.mesh_dim_names
        col = names[1] if self.tp > 1 else None
        return [[Shard(t.dim() - 1) if (s and name == col) else Replicate()
                 for name in names]
                for t, s in zip(tree_leaves(params), self.sharded)]

    def state(self, params, opt_state) -> dict:
        """The training state as models/checkpoint_dist saves it: the
        parameters as DTensors over this rank's shards (views of them: a
        restore writes into the parameters) and the optimizer."""
        from torch.distributed.tensor import DTensor

        with torch.no_grad():
            dts = [DTensor.from_local(t, self.mesh, pl, run_check=False)
                   for t, pl in zip(tree_leaves(params), self.placements(params))]
        return {"params": tree_unflatten(params, dts), "opt": opt_state}


def make_dist_train_step(
    adjacency,
    mesh,
    dims: Sequence[int],
    model: str = "gcn",
    block_size: int = 128,
    strategy: str = "allgather",
    optimizer: Optional[Callable[..., torch.optim.Optimizer]] = None,
    seed: int = 0,
    dtype=None,
    params=None,
    device=None,
):
    """Build (params, opt_state, step) for this rank (every rank calls it
    with the same arguments).

    adjacency: a (normalized) CSR (cut into blocks of block_size), a BSR,
    or a Hybrid (the JAX step's dist_hybrid_spmm_plan branch: dense
    stripes plus the distributed ELL remainder, no feature axis).
    strategy: the plan's ("allgather", "ring", "halo"); the local product
    is the "xla" one. optimizer: a torch.optim class or factory taking
    the parameter list (default: Adam at lr 1e-2, JAX's optax.adam(1e-2)).
    params: the whole initial tree (e.g. models.params_from_jax of the
    JAX package's init), else MODELS[model]'s init drawn from a
    torch.Generator seeded `seed`. Returns this rank's shards as params,
    the optimizer over them as opt_state, and a DistTrainStep. device:
    the rank's device (None: cuda:{rank % GPUs}; "cpu" for CPU ranks)."""
    device = rank_device(device)
    row_axis = mesh.mesh_dim_names[0]
    col_axis = _col_axis(mesh)
    if isinstance(adjacency, Hybrid):
        plan = dist_hybrid_spmm_plan(adjacency, mesh=mesh, axis=row_axis,
                                     strategy=strategy, dtype=dtype, device=device)
    else:
        bsr = csr_to_bsr(adjacency, block_size) if isinstance(adjacency, CSR) else adjacency
        if not isinstance(bsr, BSR):
            raise TypeError(f"adjacency must be a CSR, BSR or Hybrid, not "
                            f"{type(adjacency).__name__}")
        plan = dist_bsr_spmm_plan(bsr, mesh=mesh, axis=row_axis, strategy=strategy,
                                  dtype=dtype, feature_axis=col_axis, device=device)
    init_fn, apply_fn = MODELS[model]
    if params is None:
        params = init_fn(list(dims), generator=torch.Generator().manual_seed(seed))
    n_col = mesh.size(mesh.mesh_dim_names.index(col_axis)) if col_axis else 1
    sharded = [_col_sharded(np.shape(t), n_col) for t in tree_leaves(params)]
    params = _shard_params(params, mesh, col_axis, device)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    optimizer = optimizer or functools.partial(torch.optim.Adam, lr=1e-2)
    opt_state = optimizer(leaves)
    step = DistTrainStep(plan, mesh, col_axis, apply_fn, sharded, dims, device)
    return params, opt_state, step


def random_problem(n_nodes: int, dims: Sequence[int], p: float = 0.05, seed: int = 0):
    """Tiny synthetic node-classification problem (for dry runs/tests),
    the JAX package's bit for bit."""
    from spmm_denseblock_tpu_torch.formats.csr import random_csr
    from spmm_denseblock_tpu_torch.models.graph import sym_norm_adjacency

    rng = np.random.default_rng(seed)
    adj = sym_norm_adjacency(random_csr(p, n_nodes, seed=seed, values="ones"))
    x = rng.standard_normal((n_nodes, dims[0])).astype(np.float32)
    y = rng.integers(0, dims[-1], size=n_nodes).astype(np.int32)
    mask = (rng.random(n_nodes) < 0.7).astype(np.float32)
    return adj, x, y, mask
