"""Run one cell of BENCHMARK.json once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Prints one JSON line last on standard output; exits non-zero, with
no line, where there is no card.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / "cache"


def _environment():
    """Every build and kernel cache inside the checkout, at fixed paths;
    no library pulls in JAX or Flax."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["USE_FLAX"] = "0"
    # the benchmark's modules are imported as the package portbench, never
    # from this directory (trace.py would shadow the standard library's)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(ROOT))


if __name__ == "__main__":
    _environment()
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], t_start=T_START))
