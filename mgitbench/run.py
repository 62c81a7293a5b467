"""Run one cell of the benchmark of ``repro_torch`` on this machine's cards.

    python3 mgitbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout (``python3 -m mgitbench.run`` works too). The
kernels are built into ``build/kernels`` inside the checkout on the first
run and found there by later ones. The last line of standard output is
the result, one JSON object. ``--control 1`` runs the cell's control (the
plain reference one precision below the configuration's in the
program's place), whose result has to read not correct; a benchmark run
never runs it.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    build = os.path.join(ROOT, "build")
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(build, "kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "nv")
    os.environ["USE_FLAX"] = "0"
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    from mgitbench import harness
    return harness.main(argv, T_START)


if __name__ == "__main__":
    sys.exit(main())
