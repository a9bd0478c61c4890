"""The benchmark of the PyTorch/CUDA port (`dlwpbench_tpu_torch`).

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

See `portbench/README.md`.  Configurations, cells, traffic mixes and
per-layer metrics are files found by name; nothing in this package
imports JAX or the JAX package."""
