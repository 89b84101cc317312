"""Tensor creation ops (port of ``paddle_tpu/ops/creation.py``).

A tensor made from nothing lands on the default device
(``set_device``; CUDA unless the CPU was asked for). Integer tensors
made without a dtype are int64 (the JAX package asks for int64 too and
its 32-bit mode narrows that to int32); floats take the default dtype.

The random ops draw from explicit ``torch.Generator``s
(``framework.random.generator_for``: the active ``rng_scope``'s, else
the device's global generator, which ``paddle.seed`` reseeds). Their
numbers cannot equal JAX's keys'; a seeded run repeats itself.
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..framework.op import primitive
from ..framework.tensor import entry
from ..framework.random import generator_for, next_rng_key
from ._util import as_t, device_of, shape_of, tdtype

__all__ = ["zeros", "ones", "full", "fill_constant", "zeros_like",
           "ones_like", "full_like", "arange", "range_", "linspace",
           "logspace", "eye", "empty", "empty_like", "diag", "diagflat",
           "tril", "triu", "meshgrid", "uniform", "uniform_random", "randn",
           "normal", "gaussian_random", "gaussian", "randint", "randperm",
           "rand", "bernoulli", "multinomial", "assign", "clone",
           "next_rng_key"]


def _dt(dtype, default_float=True):
    if dtype is None:
        return dtype_mod.default_torch_dtype() if default_float \
            else torch.int64
    return dtype_mod.to_torch(dtype)


def _scalar(v):
    return v.item() if isinstance(v, torch.Tensor) else v


@entry
def zeros(shape, dtype=None, name=None):
    return torch.zeros(shape_of(shape), dtype=_dt(dtype),
                       device=device_of())


@entry
def ones(shape, dtype=None, name=None):
    return torch.ones(shape_of(shape), dtype=_dt(dtype), device=device_of())


@entry
def full(shape, fill_value, dtype=None, name=None):
    return torch.full(shape_of(shape), _scalar(fill_value), dtype=_dt(dtype),
                      device=device_of())


fill_constant = full


@primitive("zeros_like")
def zeros_like(x, dtype=None):
    return torch.zeros_like(x, dtype=tdtype(dtype))


@primitive("ones_like")
def ones_like(x, dtype=None):
    return torch.ones_like(x, dtype=tdtype(dtype))


@primitive("full_like")
def full_like(x, fill_value, dtype=None):
    return torch.full_like(x, _scalar(fill_value), dtype=tdtype(dtype))


@entry
def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _scalar(start), _scalar(end), _scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        if any(isinstance(v, float) for v in (start, end, step)):
            dtype = dtype_mod.default_torch_dtype()
        else:
            dtype = torch.int64
    dt = dtype_mod.to_torch(dtype)
    if dt.is_floating_point:
        # JAX/numpy: ceil((end - start) / step) values of start + i*step
        n = max(int(np.ceil((end - start) / step)), 0)
        return (torch.arange(n, dtype=torch.float64, device=device_of())
                * step + start).to(dt)
    return torch.arange(start, end, step, dtype=dt, device=device_of())


range_ = arange


@entry
def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          dtype=_dt(dtype), device=device_of())


@entry
def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(_scalar(start), _scalar(stop), int(_scalar(num)),
                          base=base, dtype=_dt(dtype), device=device_of())


@entry
def eye(num_rows, num_columns=None, dtype=None, name=None):
    return torch.eye(num_rows, num_columns if num_columns is not None
                     else num_rows, dtype=_dt(dtype), device=device_of())


@entry
def empty(shape, dtype=None, name=None):
    return torch.zeros(shape_of(shape), dtype=_dt(dtype), device=device_of())


@entry
def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype=dtype)


@entry
def diag(x, offset=0, padding_value=0, name=None):
    v = as_t(x)
    if v.dim() == 1 and padding_value != 0:
        n = v.shape[0] + abs(offset)
        out = torch.full((n, n), padding_value, dtype=v.dtype,
                         device=v.device)
        idx = torch.arange(v.shape[0], device=v.device)
        r = idx + max(0, -offset)
        c = idx + max(0, offset)
        return out.index_put((r, c), v)
    return torch.diag(v, offset)


@entry
def diagflat(x, offset=0, name=None):
    return torch.diagflat(as_t(x), offset)


@entry
def tril(x, diagonal=0, name=None):
    return _tril(x, diagonal=diagonal)


@primitive("tril")
def _tril(x, diagonal=0):
    return torch.tril(x, diagonal)


@entry
def triu(x, diagonal=0, name=None):
    return _triu(x, diagonal=diagonal)


@primitive("triu")
def _triu(x, diagonal=0):
    return torch.triu(x, diagonal)


@entry
def meshgrid(*args, name=None):
    arrays = args[0] if len(args) == 1 and isinstance(
        args[0], (list, tuple)) else args
    return list(torch.meshgrid(*[as_t(a) for a in arrays], indexing="ij"))


# -- random ----------------------------------------------------------------
def _gen(seed, device):
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return generator_for(device)


@entry
def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = device_of()
    dt = _dt(dtype)
    out = torch.empty(shape_of(shape), dtype=dt, device=dev)
    return out.uniform_(float(min), float(max), generator=_gen(seed, dev))


uniform_random = uniform


@entry
def randn(shape, dtype=None, name=None):
    dev = device_of()
    return torch.randn(shape_of(shape), dtype=_dt(dtype), device=dev,
                       generator=_gen(0, dev))


@entry
def normal(mean=0.0, std=1.0, shape=None, name=None):
    dt = dtype_mod.default_torch_dtype()
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        dev = device_of(mean, std)
        m, s = as_t(mean), as_t(std)
        shp = torch.broadcast_shapes(m.shape, s.shape)
        n = torch.randn(shp, dtype=dt, device=dev, generator=_gen(0, dev))
        return m + s * n
    dev = device_of()
    shp = shape_of(shape if shape is not None else [1])
    n = torch.randn(shp, dtype=dt, device=dev, generator=_gen(0, dev))
    return mean + std * n


gaussian_random = normal
gaussian = normal


@entry
def randint(low=0, high=None, shape=(1,), dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = device_of()
    return torch.randint(int(low), int(high), shape_of(shape),
                         dtype=_dt(dtype, default_float=False), device=dev,
                         generator=_gen(0, dev))


@entry
def randperm(n, dtype=None, name=None):
    dev = device_of()
    return torch.randperm(int(n), device=dev, generator=_gen(0, dev)).to(
        _dt(dtype, default_float=False))


@entry
def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


@entry
def bernoulli(x, name=None):
    p = as_t(x)
    return torch.bernoulli(p, generator=_gen(0, p.device)).to(p.dtype)


@entry
def multinomial(x, num_samples=1, replacement=False, name=None):
    p = as_t(x)
    return torch.multinomial(p, num_samples, replacement,
                             generator=_gen(0, p.device)).to(torch.int64)


@entry
def assign(x, output=None):
    v = _assign(x)
    if output is not None:
        output.set_value(v)
        return output
    return v


@primitive("assign")
def _assign(x):
    return torch.clone(as_t(x))


@entry
def clone(x, name=None):
    return assign(x)
