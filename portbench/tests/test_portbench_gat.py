"""The GAT's side of the benchmark on the CPU: the plain reference's
blocked float64 forward against an unblocked one, its attention pattern
against the port's, the adapter's answers against the reference, and the
work figures counted from the configuration's pattern."""

import numpy as np
import pytest
import torch

from portbench import correct, graphgen, harness, reference, spec
from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.models.graph import gat_pattern

GAT = spec.model("graph_attention")
SYSTEM = spec.system("graph_attention")
CELL = spec.load_cell("gat-arxiv.serve")


def small(n=300, nnz=3000, dims=(16, 12, 12, 5)):
    edges = graphgen.synthetic_powerlaw_edges(n, nnz, seed=1234)
    config = dict(CELL.config, dims=list(dims))
    inputs = harness.make_inputs(config, CELL.mix, n, 7, "cpu", GAT, spec.kind("serve"))
    return config, edges, inputs


def test_blocked_forward_equals_unblocked():
    """In float64, blocks of 64 edges give what one block of every edge
    gives, within 1e-12 of max |y| (the same sums, added in another
    order)."""
    config, edges, inputs = small()
    prec = reference._Precision(False)
    adj = GAT.adjacency(edges, 300, torch.float64, "cpu")
    ps = reference.cast_params(inputs["params"], torch.float64)
    x = inputs["pool"][0].double()
    blocked = GAT.forward(adj, ps, x, prec, edge_block=64)
    whole = GAT.forward(adj, ps, x, prec, edge_block=adj["rows"].numel())
    assert blocked.shape == (300, 5)
    assert correct.rel_err(blocked, whole) < 1e-12


def test_reference_pattern_is_the_ports():
    """The reference's pattern, built from the raw edges, holds the same
    entries as the port's gat_pattern, in row order."""
    _, edges, _ = small()
    adj = GAT.adjacency(edges, 300, torch.float64, "cpu")
    port = gat_pattern(CSR.from_edges(edges, n_rows=300))
    assert np.array_equal(adj["rows"].numpy(), port.row_ids())
    assert np.array_equal(adj["cols"].numpy(), np.asarray(port.indices))


@pytest.mark.parametrize("ordering", ["gorder", "rcmk"])
def test_adapter_serves_as_the_reference(ordering):
    """The adapter's request (the pattern, its ordering, the plan route),
    in the benchmark's node order, within 1e-5 of the float64 reference
    (float32 sums, three layers)."""
    config, edges, inputs = small()
    config["ordering"] = ordering
    system = SYSTEM.System(config, CELL.mix, 300, edges, "cpu", 0.0)
    system.load_serving(inputs["params"])
    x = inputs["pool"][1]
    (ref,) = reference.serve(GAT, edges, 300, inputs["params"], [x])
    assert correct.rel_err(system.request(x), ref) < 1e-5


def test_work_counts_the_configurations_entries():
    """At the configuration's size the FLOPs and the SpMM bound count its
    2,448,931 attention entries, whatever nnz the harness passes, and
    the residual projections beside the projections; the bound is the three aggregations' bytes (F = 750, 750, 120, three f32
    values an entry): about 0.69 ms."""
    config, n = CELL.config, CELL.config["graph"]["n"]
    E = config["attention"]["nnz"]
    assert GAT.flops(config, n, 1, False) == GAT.flops(config, n, 10**9, False)
    want = sum(2 * 2 * n * a * b + 4 * n * b + 2 * E * b
               for a, b in ((128, 750), (750, 750), (750, 120)))
    assert GAT.flops(config, n, 0, False) == want
    bound = GAT.spmm_bound_s(config, n, 0, False, "f32")
    assert 0.68e-3 < bound < 0.70e-3
