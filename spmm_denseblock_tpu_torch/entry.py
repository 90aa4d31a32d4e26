"""Entry point of the flagship model (twin of ``__graft_entry__.entry``):
a GCN over the BSR SpMM plan, trainable (the plan is built with the
default grad=True, so its backward runs Aᵀ's kernel).

    fn, (params, x) = entry()
    out = fn(params, x)            # (512, 16) logits

The JAX package's ``dryrun_multichip`` needs the distributed layer,
which is not ported yet (ROADMAP queue 1 item 12).

    python -m spmm_denseblock_tpu_torch.entry [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def entry(device=None):
    """(fn, (params, x)): fn(params, x) is the GCN forward over the plan;
    n=512, dims [32, 64, 16], bsr_pallas at b=128, seeds as the JAX
    entry (weights from a torch.Generator seeded 0, which draws other
    numbers than jax.random.PRNGKey(0)). device: None is the card."""
    from spmm_denseblock_tpu_torch.formats.csr import random_csr
    from spmm_denseblock_tpu_torch.models import gcn_apply, init_gcn, sym_norm_adjacency
    from spmm_denseblock_tpu_torch.ops import spmm_plan
    from spmm_denseblock_tpu_torch.ops._device import resolve_device

    device = resolve_device(device)

    n, dims = 512, [32, 64, 16]
    adj = sym_norm_adjacency(random_csr(0.02, n, seed=0, values="ones"))
    spmm = spmm_plan(adj, impl="bsr_pallas", block_size=128, device=device)
    params = init_gcn(dims, generator=torch.Generator().manual_seed(0),
                      device=device)
    x = np.random.default_rng(0).standard_normal((n, dims[0])).astype(np.float32)

    def fn(params, x):
        return gcn_apply(params, spmm, torch.as_tensor(x, device=device))

    return fn, (params, x)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the plan and weights live (default: the card)")
    args = ap.parse_args(argv)
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    print("entry:", tuple(out.shape), float(out.abs().mean()))


if __name__ == "__main__":
    main()
