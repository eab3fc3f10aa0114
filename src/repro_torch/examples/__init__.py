"""Twins of the JAX package's `examples/` over the port: the same flags
and prints, plus --device (CUDA unless "cpu" is asked for; no fallback).
Each runs as `python -m repro_torch.examples.<name>`."""
