# Hand-written Hopper (sm_90a) kernels replacing the reference's Pallas TPU
# kernels.  Each wrapper launches its CUDA kernel on CUDA tensors and runs
# its plain PyTorch version on CPU tensors; sources live in ../csrc/.
