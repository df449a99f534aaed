"""The benchmark of reseek_tpu_torch, the PyTorch and CUDA port, on one
H100: one cell a run, found by name in BENCHMARK.json.

    python3 -m portbench --workload NAME --seed N --seconds S --trace 0|1

Configurations (portbench/configs/<name>.json), traffic mixes
(portbench/traffic/<config>.<traffic>.json) and metrics
(portbench/metrics/<metric>.py) each sit in files of their own; the
traffic's ``kind`` names its module in portbench/kinds.  The reference
the outputs are held to is a frozen copy of the port's host layer
(portbench/reference); the JAX package is never imported.
"""
