"""The benchmark of ``tensor_ops_tpu_torch`` on one NVIDIA H100: see
``perfbench/README.md``.  It imports neither JAX nor the JAX package."""
