"""The plain reference against the port at a tiny size on the CPU, serve
and train, and the frozen stand-in graph against the port's generator."""

import functools

import numpy as np
import torch

from portbench import correct, graphgen, harness, reference, spec
from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.io.datasets import synthetic_powerlaw
from spmm_denseblock_tpu_torch.models.gnn import gcn_apply
from spmm_denseblock_tpu_torch.models.graph import sym_norm_adjacency
from spmm_denseblock_tpu_torch.models.train import make_train_step
from spmm_denseblock_tpu_torch.ops.dispatch import spmm_plan
from spmm_denseblock_tpu_torch.reorder import reorder

N, NNZ = 400, 5000


def graph():
    edges = graphgen.synthetic_powerlaw_edges(N, NNZ, seed=1234)
    return edges, CSR.from_edges(edges, n_rows=N)


def test_frozen_generator_matches_the_port():
    _, mine = graph()
    port = synthetic_powerlaw(N, NNZ, seed=1234)
    assert np.array_equal(mine.indptr, port.indptr)
    assert np.array_equal(mine.indices, port.indices)


GCN = spec.model("gcn")


def port_inputs(dims, seed=5):
    cell = spec.load_cell("gcn-arxiv.train")
    cfg = dict(cell.config, dims=dims)
    return harness.make_inputs(cfg, cell.mix, N, seed, "cpu", GCN, spec.kind("train"))


def test_reference_serves_as_the_port():
    edges, csr = graph()
    dims = [16, 12, 5]
    inputs = port_inputs(dims)
    x = inputs["x"]
    r, old2new = reorder(csr, "rcmk")
    plan = spmm_plan(sym_norm_adjacency(r), impl="csr_pallas", grad=False, device="cpu")
    o2n = torch.as_tensor(old2new).long()
    y = gcn_apply(inputs["params"], plan, x[torch.argsort(o2n)])[o2n]
    (ref,) = reference.serve(GCN, edges, N, inputs["params"], [x])
    assert correct.rel_err(y, ref) < 1e-6


def test_reference_trains_as_the_port():
    edges, csr = graph()
    dims = [16, 12, 5]
    inputs = port_inputs(dims)
    adj = sym_norm_adjacency(csr)  # the original order: the loss is the same
    plan = spmm_plan(adj, impl="csr_pallas", grad=True, device="cpu")
    params = [{k: v.clone() for k, v in p.items()} for p in inputs["params"]]
    step, init = make_train_step(gcn_apply, plan,
                                 functools.partial(torch.optim.Adam, lr=0.01))
    opt = init(params)
    losses = []
    for i in range(3):
        params, opt, m = step(params, opt, inputs["x"], inputs["labels"], inputs["mask"])
        losses.append(float(m["loss"]))
        if i == 0:
            grads = [opt.state[p[k]]["exp_avg"] / 0.1 for p in params for k in ("w", "b")]
    start = [p[k] for p in inputs["params"] for k in ("w", "b")]
    change = [t.detach() - s for t, s in zip(
        [p[k] for p in params for k in ("w", "b")], start)]
    ref = reference.train(GCN, edges, N, inputs["params"], inputs["x"],
                          inputs["labels"], inputs["mask"], 0.01, 3)
    ref_change = [a - s.double() for a, s in zip(ref[2], start)]
    numbers = correct.train_numbers(losses, grads, change, ref[0], ref[1], ref_change)
    assert max(numbers.values()) < 1e-5, numbers
    assert losses[2] < losses[0]
