"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one NVIDIA
H100 (Hopper, sm_90a).

The port is a package beside ``paddle_tpu`` and never imports it or
JAX. Its public surface is the JAX package's: ``Tensor``/``to_tensor``
(a ``torch.Tensor`` subclass with paddle's methods), ``grad`` and
``autograd.PyLayer`` over torch autograd, the op library
(``paddle_tpu_torch.matmul``, ``concat``, ``reshape`` ...; ``ops``,
``tensor``), ``seed``, ``set_device``/``get_device``, dtypes, flags,
``save``/``load``, and the subsystems: ``nn``, ``optimizer``, ``amp``,
``jit.TrainStep``, ``models`` (BERT, GPT-2, the Transformer NMT),
``vision``, ``static`` (Program, Executor), ``inference`` (paged-KV
decode serving), ``serving``, ``distributed``/``parallel`` (ranks, a
mesh, collectives, ring attention), ``io``, ``incubate``, with
hand-written CUDA kernels for flash attention, the fused vocabulary
cross-entropy, the fused optimizer updates, paged attention, sampling
and the embedding bag (``ops.cuda``). A user's script runs with only
its import changed (``import paddle_tpu_torch as paddle``).

Entry points run on the card unless the caller asks for the CPU
(``set_device("cpu")``, or ``device="cpu"``); without a GPU and
without either they raise.
"""
from __future__ import annotations

__version__ = "0.1.0"

from .framework import (  # noqa: F401
    Tensor, to_tensor, is_tensor, no_grad, enable_grad, seed,
    set_default_dtype, get_default_dtype, set_device, get_device,
    device_count, CPUPlace, TPUPlace, CUDAPlace, CUDAPinnedPlace, XPUPlace,
    is_compiled_with_tpu, is_compiled_with_cuda, get_flags, set_flags,
    rng_scope)
from .framework.dtype import (  # noqa: F401
    bool_, uint8, int8, int16, int32, int64, float16, bfloat16, float32,
    float64, complex64, complex128)
from .framework import math_op_patch  # noqa: F401  (Tensor operators)
from .ops import *  # noqa: F401,F403
from .ops import unwrap, primitive, next_rng_key  # noqa: F401
from .ops.manipulation import builtins_min, getitem  # noqa: F401
from . import (amp, distributed, framework, incubate, inference, io,  # noqa
               jit, models, nn, ops, optimizer, parallel, profiler,
               regularizer, static, utils, vision)
from . import autograd  # noqa: F401
from .autograd import grad  # noqa: F401


def save(obj, path, **kwargs):
    from .io.serialization import save as _save

    return _save(obj, path, **kwargs)


def load(path, **kwargs):
    from .io.serialization import load as _load

    return _load(path, **kwargs)


from . import tensor  # noqa: E402,F401
from . import dygraph  # noqa: E402,F401

_TENSOR_NAMES = {
    "t", "reduce_all", "reduce_any", "reduce_max", "reduce_min",
    "reduce_prod", "reduce_sum", "reduce_mean", "sums", "elementwise_sum",
    "elementwise_floordiv", "addcmul", "standard_normal", "shuffle",
    "numel"}


def __getattr__(name):
    """The JAX package's lazy top-level aliases (``paddle_tpu/__init__.py
    :74-123``) whose targets the port has."""
    if name in _TENSOR_NAMES:
        return getattr(tensor, name)
    if name == "manual_seed":
        return seed
    if name == "to_variable":
        return dygraph.to_variable
    if name in ("enable_static", "disable_static", "in_dynamic_mode",
                "in_dygraph_mode", "enable_imperative",
                "disable_imperative"):
        from .framework import mode as _mode

        return getattr(_mode, name)
    if name in ("Variable", "data"):
        return getattr(static, name)
    if name == "ParamAttr":
        return nn.ParamAttr
    if name == "BackwardStrategy":
        return dygraph.BackwardStrategy
    if name in ("NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
                "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
                "CosineDecay"):
        return getattr(dygraph, name)
    if name == "get_cudnn_version":
        import torch

        return torch.backends.cudnn.version
    raise AttributeError(name)
