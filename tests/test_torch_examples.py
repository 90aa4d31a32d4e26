"""The port's examples (spmm_denseblock_tpu_torch/examples) and its
multi-rank dry run (entry.dryrun_multichip) on the CPU at tiny sizes:
each example's main with --device cpu (train_gcn's loss falls,
serve_spmm's answer within 1e-4 of scipy, molecule_study writes its
table under build/ and trains, dist_train resumes from its sharded
checkpoint with the losses of a run that never stopped, bit for bit),
every pass of dryrun_multichip(4) on CPU ranks, and the card as the
default of both: without a GPU they raise."""

import re

import pytest
import torch

from spmm_denseblock_tpu_torch.entry import dryrun_multichip
from spmm_denseblock_tpu_torch.examples import (
    dist_train,
    molecule_study,
    serve_spmm,
    train_gcn,
)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _own_dir(tmp_path, monkeypatch):
    """The examples cache graphs under ./tmp and write under ./build."""
    monkeypatch.chdir(tmp_path)


def test_train_gcn(capsys):
    train_gcn.main(["--scale", "0.005", "--epochs", "3", "--dims", "16", "32", "8",
                    "--device", "cpu"])
    losses = [float(v) for v in re.findall(r"loss (\S+)", capsys.readouterr().out)]
    assert len(losses) == 2 and losses[1] < losses[0]


def test_serve_spmm(capsys):
    serve_spmm.main(["--scale", "0.005", "--dim", "16", "--impl", "csr_ell",
                     "--check", "--device", "cpu"])
    out = capsys.readouterr().out
    assert float(re.search(r"rel err (\S+)", out).group(1)) < 1e-4
    assert "ms/call" in out


def test_molecule_study(tmp_path):
    rec = molecule_study.main(["--n-graphs", "12", "--train", "--device", "cpu"])
    path = tmp_path / "build" / "molecule_study" / "ogbg_molecule_study.jsonl"
    assert path.exists() and not (tmp_path / "benchmarks").exists()
    assert set(rec["table"]) == {"original", "rcmk", "closest"}
    assert rec["classifier_loss"] > 0


def test_dist_train_resumes_bit_exact(tmp_path):
    base = ["--ranks", "4", "--device", "cpu", "--n-nodes", "256", "--col-parallel", "2"]
    whole = dist_train.main(base + ["--epochs", "6"])
    first = dist_train.main(base + ["--epochs", "4", "--ckpt-dir", "ck", "--ckpt-every", "2"])
    resumed = dist_train.main(base + ["--epochs", "6", "--ckpt-dir", "ck"])
    assert first["start"] == 0 and first["losses"] == whole["losses"][:4]
    assert resumed["start"] == 4 and resumed["losses"] == whole["losses"][4:]
    assert whole["losses"][-1] < whole["losses"][0]


def test_dryrun_multichip_on_cpu_ranks():
    lines = dryrun_multichip(4, device="cpu", realistic_block_rows=8)
    names = [line.split(":")[0] for line in lines]
    assert names == ["dryrun_multichip(4)", "dryrun_hybrid_ell", "dryrun_bsr_int8",
                     "dryrun_ell_int8_compact", "dryrun_ring_pallas",
                     "dryrun_ring_pallas_int8", "dryrun_balanced_halo",
                     "dryrun_realistic", "dryrun_readiness_harness"]
    assert all(line.endswith(" ok") for line in lines)
    assert "mesh=(2, 2)" in lines[0]


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        dryrun_multichip(4)
    for main, argv in ((dist_train.main, ["--ranks", "2"]),
                       (train_gcn.main, ["--epochs", "1"]),
                       (serve_spmm.main, [])):
        with pytest.raises(RuntimeError, match="GPU"):
            main(argv)
