"""PyTorch / CUDA port of the `repro` package (quantization-variation QAT
and int-coded serving) for NVIDIA Hopper GPUs.

Slice 1 ports the serving path: `launch.serve` -> `serve.ServeEngine` ->
`serve.ModelExecutor` -> `models.model.prefill_step` / `decode_step`, with
hand-written CUDA kernels in `kernels/csrc`. Nothing here imports JAX or
the `repro` package; `bridge` carries weights across as numpy.
"""
