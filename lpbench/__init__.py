"""lpbench: the benchmark of the PyTorch/CUDA port (``repro_torch``).

``python3 lpbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one card.  The
yardstick lives here and nowhere in the program: the input generators and
the plain reference (``reference/``), the comparison (``judge.py``), the
card's peaks and the bytes of a solve (``peaks.py``), the reading of a
profiler trace (``trace.py``) and one reader a metric (``metrics/``).
Configurations (``configs/``) and traffic mixes (``traffic/``) are data
files that the one generator (``loadgen.py``) reads; the loop a mix names
(``loops/``), the kind of problem a configuration names (``problems/``)
and its reference are files found by name (``spec.py``), and share what
``drivers.py`` holds.  Nothing here imports ``jax`` or the JAX package.
"""
