"""Padding helpers (twin of ``spmm_denseblock_tpu/convert/pack.py``;
only ``round_up`` is on the ported path so far)."""


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m
