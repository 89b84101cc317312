"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100 (Hopper, sm_90a).

The port is a package beside ``paddle_tpu`` and never imports it or
JAX. It grows slice by slice: paged-KV decode serving
(``inference.decode``) with CUDA kernels for paged attention and fused
sampling, then the BERT pretraining step (``models.bert``, ``nn``,
``amp``, ``optimizer``, ``jit.TrainStep``) with CUDA kernels for flash
attention, the fused vocabulary cross-entropy and the fused Adam update
(``ops.cuda``), and at AMP O2 (``amp.decorate``, ``amp.GradScaler``,
``multi_precision``, regularizer objects, ``nn.ParamAttr``) with the
cross-entropy over bf16/f16 inputs and the updates' master-weight
forms, then ResNet training (``vision.models``: convolution,
batch norm, pooling; ``optimizer.Momentum``) with a CUDA kernel for the
fused Momentum update, then BERT phase-2 pretraining at seq 512 with
``optimizer.Lamb`` (``optimizer.lr`` schedulers, ``nn.clip``) through
the short-sequence flash kernels (``FLAGS_flash_short_seq``), and
``optimizer.SGD``, with CUDA kernels for both updates, then the static
graph (``static``: Program, Executor, ``append_backward``, the static
optimizers) with CUDA kernels for K3's static update forms, then the
fused embedding bag (``nn.functional.fused_embedding_seq_pool``,
``incubate.layers.fused_embedding_seq_pool``) and key-padding masks
through the flash kernels, each with its CUDA kernel, then
sequence-parallel GPT-2 training over ranks (``models.gpt``,
``distributed``, ``parallel``: a mesh of ranks, collectives, ring
attention) with a CUDA entry for the flash backward's external-lse
form. Entry points
run on the card unless the caller passes ``device="cpu"``; without a
GPU and without a device they raise.
"""
from . import (amp, distributed, framework, incubate, inference, io, jit,
               models, nn, ops, optimizer, parallel, profiler, regularizer,
               static, utils, vision)
from .framework.flags import get_flags, set_flags
from .framework.random import seed

__all__ = ["amp", "distributed", "framework", "incubate", "inference",
           "io", "jit", "models", "nn", "ops", "optimizer", "parallel",
           "profiler", "regularizer", "seed", "static", "utils", "vision",
           "get_flags", "set_flags"]
