"""The port's utils/profiling against the JAX package's, on the CPU:
roofline gives JAX's numbers for the same inputs (with and without
peaks, the H100's among them); device_info(device="cpu") has the keys
JAX's gives on the CPU, and raises without a GPU when asked for the card;
trace() writes a Chrome trace that names an annotate() range; the H100
peaks are the figures PERF.md states."""

import importlib
import json

import numpy as np
import pytest
import torch

import spmm_denseblock_tpu.utils as j_utils
import spmm_denseblock_tpu_torch.utils as t_utils

TP = importlib.import_module("spmm_denseblock_tpu_torch.utils.profiling")

torch.set_num_threads(2)


@pytest.mark.parametrize("flops,nbytes,secs", [
    (6.93e11, 2.4e9, 8.95e-3),   # the op shape's f32 K2 record
    (3.3e8, 7.1e7, 3.5e-4),      # a memory-bound CSR SpMM
    (2.0, 8.0, 1e-6),            # two flops, eight bytes
])
@pytest.mark.parametrize("peaks", [None, (197e12, 819e9), (67e12, 3.35e12)])
def test_roofline_equals_jax(flops, nbytes, secs, peaks):
    kw = {} if peaks is None else {"peak_flops": peaks[0], "peak_bw": peaks[1]}
    assert t_utils.roofline(flops, nbytes, secs, **kw) == \
        j_utils.roofline(flops, nbytes, secs, **kw)


def test_h100_peaks():
    assert TP.HBM_BYTES_S == 3.35e12
    assert TP.PEAK_OPS_S == {"f32": 67e12, "high": 989e12, "bf16": 989e12,
                             "int8": 1979e12}


def test_device_info_keys(monkeypatch):
    info = t_utils.device_info(device="cpu")
    assert set(info) == set(j_utils.device_info())
    assert info == {"backend": "cpu", "n_devices": 1, "platform": "cpu",
                    "device_kind": "cpu"}
    json.dumps(info)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        t_utils.device_info()


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.as_tensor(np.ones((64, 64), np.float32))
    with t_utils.trace(str(tmp_path / "tr")) as prof:
        with t_utils.annotate("sdb_test_range"):
            (x @ x).sum()
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "sdb_test_range" for e in events)
    assert prof is not None
