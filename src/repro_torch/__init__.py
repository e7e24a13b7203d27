"""PyTorch/CUDA port of the Memori memory layer (the JAX package `repro` is
the reference).  Module names and layout mirror `repro`; every Pallas TPU
kernel on a ported path is a hand-written CUDA kernel under `csrc/`, bound
through `kernels/`.  Nothing here imports `jax` or `repro`."""
