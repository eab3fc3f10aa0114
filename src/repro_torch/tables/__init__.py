"""Twins of the JAX package's paper-table drivers (`benchmarks/table*.py`):
the same file names, row names, defaults and `run(steps=...)` signatures,
over the port. Each runs as `python -m repro_torch.tables.<name>
[--device cpu] [--steps N]`; CUDA is the default, with no fallback. Random
inits come from torch generators, so the values differ from the
reference's; the row names and the directions they test carry over."""
