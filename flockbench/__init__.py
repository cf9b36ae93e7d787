"""flockbench — the benchmark of ``flock_tpu_torch``, the PyTorch and CUDA
port, on NVIDIA cards.  ``python3 -m flockbench.run --help`` runs one cell;
``BENCHMARK.json`` at the checkout's root lists the cells.  Nothing here
imports JAX or the JAX package."""
