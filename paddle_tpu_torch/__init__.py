"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100 (Hopper, sm_90a).

The port is a package beside ``paddle_tpu`` and never imports it or
JAX. It grows slice by slice; the first slice is paged-KV decode
serving (``inference.decode``) with hand-written CUDA kernels for paged
attention (f32 and int8 pools) and fused sampling (``ops.cuda``).
Entry points run on the card unless the caller passes
``device="cpu"``; without a GPU and without a device they raise.
"""
from . import inference, ops, profiler

__all__ = ["inference", "ops", "profiler"]
