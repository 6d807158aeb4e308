"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 radbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` and prints one JSON result line.  The
harness finds a cell's configuration (``configs/<name>.json``), traffic mix
(``traffic/<name>.json``), the program entry the mix drives
(``entries/<entry>.py``) and metric readers (``metrics/<name>.py``) by the
names in ``BENCHMARK.json`` and the mix; the yardstick
(case generator, plain reference, work and peak tables) lives here too.
Nothing in this package imports the JAX package or JAX.
"""
