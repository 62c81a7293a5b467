"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of MGit.

Run one cell with ``python3 mgitbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. Cells, metrics
and configurations are named in ``BENCHMARK.json``; each configuration is a
file under ``configs/``, each traffic mix a file under ``traffic/``, each
metric a module under ``metrics/``. The yardstick (traffic generation, the
FLOP and byte formulas, the peaks, the plain references and the comparison
that decides ``correct``) lives here, frozen, and imports nothing of the
JAX package.
"""
