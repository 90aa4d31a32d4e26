from spmm_denseblock_tpu_torch.models.gnn import (
    GCN,
    gcn_apply,
    gcn_params_from_jax,
    init_gcn,
)
from spmm_denseblock_tpu_torch.models.train import (
    accuracy,
    make_eval_step,
    make_train_step,
    masked_cross_entropy,
)
from spmm_denseblock_tpu_torch.models.graph import (
    add_self_loops,
    mean_adjacency,
    sym_norm_adjacency,
)

__all__ = [
    "GCN",
    "gcn_apply",
    "gcn_params_from_jax",
    "init_gcn",
    "add_self_loops",
    "mean_adjacency",
    "sym_norm_adjacency",
    "accuracy",
    "make_eval_step",
    "make_train_step",
    "masked_cross_entropy",
]
