"""Hand-written CUDA kernels of the port, one module per TPU kernel they
replace, each with its plain PyTorch version beside it."""
