"""Hand-written Hopper kernels, one module per kernel: the wrapper (which
launches the kernel on CUDA tensors and counts its launches), the plain
PyTorch version the wrapper runs on CPU tensors, and the shape gate."""
