"""Block-occupancy heatmaps (twin of
``spmm_denseblock_tpu/analyze/heatmap.py``): the reference's
getHeatmap / dumpHeatmap (utility.cc:71-101) count the nonzeros of each
(block row, block col) cell and dump them as text; plot_heatmap renders
one where matplotlib can be imported."""

from __future__ import annotations

import numpy as np

from spmm_denseblock_tpu_torch.formats.csr import CSR


def heatmap(csr: CSR, block_size: int = 256) -> np.ndarray:
    rows = csr.row_ids().astype(np.int64) // block_size
    cols = np.asarray(csr.indices, dtype=np.int64) // block_size
    nbr = -(-csr.shape[0] // block_size)
    nbc = -(-csr.shape[1] // block_size)
    h = np.zeros((nbr, nbc), dtype=np.int64)
    np.add.at(h, (rows, cols), 1)
    return h


def dump_heatmap(h: np.ndarray, path: str) -> None:
    """Text: an 'nbr nbc' header, then one row per line."""
    with open(path, "w") as f:
        f.write(f"{h.shape[0]} {h.shape[1]}\n")
        for row in h:
            f.write(" ".join(str(int(x)) for x in row) + "\n")


def load_heatmap(path: str) -> np.ndarray:
    with open(path) as f:
        nbr, nbc = map(int, f.readline().split())
        return np.loadtxt(f, dtype=np.int64).reshape(nbr, nbc)


def plot_heatmap(h: np.ndarray, path: str, crop: int | None = None) -> bool:
    """Render as the reference's plot.py (whole) or plot1.py (a crop).
    Returns False when matplotlib cannot be imported."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    data = h if crop is None else h[:crop, :crop]
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(np.log1p(data), cmap="hot", interpolation="nearest")
    ax.set_xlabel("block col")
    ax.set_ylabel("block row")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return True
