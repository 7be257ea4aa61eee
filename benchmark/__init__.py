"""The benchmark of `gme_tpu_torch`, the PyTorch and CUDA port.

One command runs one cell of `BENCHMARK.json` once:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that measures lives here and imports nothing of the JAX package:
the clip generator (`clips`), the window arithmetic (`window`), the trace
reduction (`trace`), the bounds of the kernels (`roofline`), the plain
reference (`reference`, which imports nothing of the port either) and the
comparison that decides `correct` (`check`).  Configurations, traffic mixes
and per-layer metrics are files of their own under `configs/`, `traffic/`
and `metrics/`, found by the names `BENCHMARK.json` gives.
"""
