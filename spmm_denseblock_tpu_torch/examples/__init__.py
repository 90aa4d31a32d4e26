"""End-to-end examples of the port (twins of the repository's
``examples/``), each runnable with ``python -m
spmm_denseblock_tpu_torch.examples.<name>``: train_gcn, serve_spmm,
dist_train and molecule_study. Each runs on the card unless given
``--device cpu``."""
