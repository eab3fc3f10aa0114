"""Hand-written CUDA kernels of the serving path and their plain PyTorch
versions (`ref`), dispatched by tensor device (`ops`)."""
