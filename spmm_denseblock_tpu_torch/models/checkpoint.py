"""Training-state checkpoints, one ``.npz`` per (params, opt_state, step)
(twin of ``spmm_denseblock_tpu/models/checkpoint.py``; a file written by
either package loads into the other).

Keys are ``p{i}`` for the parameters and ``o{i}`` for the optimizer
state, in JAX's leaf order (``jax.tree.flatten``: lists and tuples in
order, dict keys sorted, None an empty subtree). ``tree_leaves`` is the
port's copy of that order; the models and ``make_train_step`` use it
too, so an optimizer's parameters come in the same order.

The optimizer state is written in the leaf layout of optax's state:

    torch.optim.Adam  ->  optax.adam:  o0 = count (int32), then mu
                          (exp_avg) and nu (exp_avg_sq), each in the
                          parameters' leaf order
    torch.optim.SGD   ->  optax.sgd:   no leaves (momentum 0 only)

Any other optimizer raises NotImplementedError.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def tree_leaves(tree: Any) -> list:
    """The leaves of a nested list/tuple/dict in JAX's leaf order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [] if tree is None else [tree]


def tree_map(fn, tree: Any) -> Any:
    """The same structure with fn applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, sub) for sub in tree)
    return None if tree is None else fn(tree)


def tree_unflatten(like: Any, leaves) -> Any:
    """like's structure with `leaves` (in JAX's leaf order) for its
    leaves; dicts keep like's key order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(sub) for sub in t)
        return None if t is None else next(it)

    return build(like)


def _normalize(path: str) -> str:
    # np.savez appends ".npz" to extensionless paths but np.load does
    # not; normalize on both sides so save("ckpt")/load("ckpt") agree.
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _optimizer_kind(opt: torch.optim.Optimizer) -> str:
    if type(opt) is torch.optim.Adam and not any(g["amsgrad"] for g in opt.param_groups):
        return "adam"
    if type(opt) is torch.optim.SGD and all(g["momentum"] == 0 for g in opt.param_groups):
        return "sgd"
    raise NotImplementedError(
        f"checkpoints hold optax's adam or sgd state: torch.optim.Adam "
        f"(amsgrad=False) or torch.optim.SGD (momentum=0), not {opt!r}")


def _opt_leaves(opt: torch.optim.Optimizer, leaves: List[torch.Tensor]) -> list:
    if _optimizer_kind(opt) == "sgd":
        return []
    states = [opt.state.get(t, {}) for t in leaves]
    count = next((int(s["step"]) for s in states if "step" in s), 0)
    mu = [_numpy(s["exp_avg"]) if s else np.zeros(t.shape, np.float32)
          for s, t in zip(states, leaves)]
    nu = [_numpy(s["exp_avg_sq"]) if s else np.zeros(t.shape, np.float32)
          for s, t in zip(states, leaves)]
    return [np.asarray(count, np.int32), *mu, *nu]


def save_checkpoint(path: str, params: Any, opt_state=None, step: int = 0):
    """params: a nested list/dict of tensors or arrays; opt_state: the
    torch.optim optimizer over those tensors, or None."""
    leaves = tree_leaves(params)
    arrs = {f"p{i}": _numpy(x) for i, x in enumerate(leaves)}
    if opt_state is not None:
        arrs.update({f"o{i}": a for i, a in enumerate(_opt_leaves(opt_state, leaves))})
    arrs["step"] = np.asarray(step)
    np.savez(_normalize(path), **arrs)


def _restore_adam(opt: torch.optim.Optimizer, leaves, z) -> None:
    group_of = {id(t): g for g in opt.param_groups for t in g["params"]}
    if any(id(t) not in group_of for t in leaves):
        raise ValueError("the optimizer does not hold every parameter of like_params")
    count, n = int(z["o0"]), len(leaves)
    for i, t in enumerate(leaves):
        g = group_of[id(t)]
        on_device = g.get("capturable") or g.get("fused")
        opt.state[t] = {
            "step": torch.tensor(float(count), dtype=torch.float32,
                                 device=t.device if on_device else "cpu"),
            "exp_avg": torch.as_tensor(z[f"o{1 + i}"]).to(t.device, t.dtype),
            "exp_avg_sq": torch.as_tensor(z[f"o{1 + n + i}"]).to(t.device, t.dtype),
        }


def load_checkpoint(path: str, like_params: Any, like_opt_state=None
                    ) -> Tuple[Any, Optional[torch.optim.Optimizer], int]:
    """Restore in place into the templates: like_params' tensors get the
    saved parameters and like_opt_state (an optimizer over those tensors,
    built with the same code) the saved state, so the optimizer stays
    bound to the parameters. Returns (like_params, like_opt_state,
    step)."""
    z = np.load(_normalize(path))
    leaves = tree_leaves(like_params)
    with torch.no_grad():
        for i, t in enumerate(leaves):
            t.copy_(torch.as_tensor(z[f"p{i}"]))
    if like_opt_state is not None and _optimizer_kind(like_opt_state) == "adam":
        _restore_adam(like_opt_state, leaves, z)
    return like_params, like_opt_state, int(z["step"])
