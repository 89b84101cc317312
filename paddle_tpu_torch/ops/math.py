"""Elementwise and reduction math ops (port of
``paddle_tpu/ops/math.py``), with the generated unary and binary
elementwise families. Each op is one or a few torch calls with the JAX
op's semantics: true division and means of integers give the default
float type, ``mod`` takes the sign of the divisor, a reduction over
``axis=None`` covers every element, ``median`` averages the two middle
values.
"""
from __future__ import annotations

import builtins
import math as _pymath
import sys

import torch

from ..framework import dtype as dtype_mod
from ..framework.op import primitive
from ..framework.tensor import entry
from ._util import as_t, axes, float_of, pair, tdtype

_mod = sys.modules[__name__]
_b_max = builtins.max


def _i0(x):
    return torch.special.i0(float_of(x))


def _frac(x):
    return x - torch.trunc(x)


def _round(x):
    # jnp.round rounds half to even, as torch.round does
    return torch.round(x)


_UNARY = {
    "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "abs": torch.abs,
    "ceil": torch.ceil, "floor": torch.floor, "round": _round,
    "trunc": torch.trunc, "cos": torch.cos, "sin": torch.sin,
    "tan": torch.tan, "acos": torch.acos, "asin": torch.asin,
    "atan": torch.atan, "cosh": torch.cosh, "sinh": torch.sinh,
    "tanh": torch.tanh, "acosh": torch.acosh, "asinh": torch.asinh,
    "atanh": torch.atanh, "reciprocal": torch.reciprocal,
    "square": torch.square, "sign": torch.sign, "erf": torch.erf,
    "erfinv": torch.erfinv, "lgamma": torch.lgamma,
    "digamma": torch.digamma, "neg": torch.neg, "conj": torch.conj_physical,
    "angle": torch.angle, "frac": _frac, "sigmoid": torch.sigmoid,
    "i0": _i0,
}
# JAX computes these in floating point whatever the input type
_FLOAT_IN = {"exp", "expm1", "log", "log2", "log10", "log1p", "sqrt",
             "rsqrt", "cos", "sin", "tan", "acos", "asin", "atan", "cosh",
             "sinh", "tanh", "acosh", "asinh", "atanh", "erf", "erfinv",
             "lgamma", "digamma", "sigmoid", "reciprocal"}


def _unary(name, f):
    def op(x, name=None):
        x = as_t(x)
        if name_ in _FLOAT_IN:
            x = float_of(x)
        return f(x)

    name_ = name
    op.__name__ = name
    return op


for _name, _fn in _UNARY.items():
    setattr(_mod, _name, primitive(_name)(_unary(_name, _fn)))


def _true_divide(x, y):
    return torch.true_divide(float_of(x) if not (
        x.is_floating_point() or y.is_floating_point()) else x, y)


def _mod_op(x, y):
    return torch.remainder(x, y)


def _pow(x, y):
    return torch.pow(x, y)


def _heaviside(x, y):
    return torch.heaviside(x, y.to(x.dtype))


def _fmax(x, y):
    return torch.fmax(x, y)


_BINARY = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": _true_divide, "floor_divide": torch.floor_divide,
    "mod": _mod_op, "remainder": _mod_op, "pow": _pow,
    "maximum": torch.maximum, "minimum": torch.minimum, "fmax": _fmax,
    "fmin": torch.fmin, "atan2": torch.atan2, "hypot": torch.hypot,
    "logaddexp": torch.logaddexp, "heaviside": _heaviside,
    "copysign": torch.copysign, "nextafter": torch.nextafter,
    "gcd": torch.gcd, "lcm": torch.lcm,
}
_FLOAT_BIN = {"atan2", "hypot", "logaddexp"}


def _binary(name, f):
    def op(x, y, name=None):
        x, y = pair(x, y)
        if name_ in _FLOAT_BIN:
            x, y = float_of(x), float_of(y)
        if name_ in ("maximum", "minimum", "fmax", "fmin", "atan2",
                     "hypot", "logaddexp", "copysign", "nextafter", "gcd",
                     "lcm", "heaviside") and x.dtype != y.dtype:
            dt = torch.promote_types(x.dtype, y.dtype)
            x, y = x.to(dt), y.to(dt)
        return f(x, y)

    name_ = name
    op.__name__ = name
    return op


for _name, _fn in _BINARY.items():
    setattr(_mod, _name, primitive(_name)(_binary(_name, _fn)))

elementwise_add = _mod.add
elementwise_sub = _mod.subtract
elementwise_mul = _mod.multiply
elementwise_div = _mod.divide
elementwise_pow = _mod.pow
elementwise_max = _mod.maximum
elementwise_min = _mod.minimum
elementwise_mod = _mod.mod
floor_mod = _mod.mod


@primitive("scale")
def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    x = as_t(x)
    s = as_t(scale, x)
    if bias_after_scale:
        out = x * s + bias
    else:
        out = (x + bias) * s
    if act == "relu":
        out = torch.relu(out)
    elif act == "tanh":
        out = torch.tanh(out)
    return out


@primitive("clip")
def clip(x, min=None, max=None, name=None):
    x = as_t(x)
    lo = min.item() if isinstance(min, torch.Tensor) else min
    hi = max.item() if isinstance(max, torch.Tensor) else max
    if lo is not None and hi is not None and lo > hi:
        # jnp.clip is minimum(maximum(x, lo), hi)
        return torch.full_like(x, hi)
    return torch.clamp(x, lo, hi)


@primitive("lerp")
def lerp(x, y, weight, name=None):
    x, y = pair(x, y)
    return x + as_t(weight, x) * (y - x)


@primitive("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * float_of(as_t(x)))


@primitive("logit")
def logit(x, eps=None, name=None):
    x = float_of(as_t(x))
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x / (1.0 - x))


@primitive("log_sigmoid")
def log_sigmoid(x, name=None):
    return torch.nn.functional.logsigmoid(float_of(as_t(x)))


@primitive("isnan")
def isnan(x, name=None):
    return torch.isnan(as_t(x))


@primitive("isinf")
def isinf(x, name=None):
    return torch.isinf(as_t(x))


@primitive("isfinite")
def isfinite(x, name=None):
    return torch.isfinite(as_t(x))


@primitive("nan_to_num")
def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return torch.nan_to_num(as_t(x), nan=nan, posinf=posinf, neginf=neginf)


@primitive("cast")
def cast(x, dtype):
    return as_t(x).to(dtype_mod.to_torch(dtype))


# -- reductions --------------------------------------------------------------
def _dims(x, axis):
    a = axes(axis)
    if a is None:
        return tuple(range(x.dim()))
    return a if isinstance(a, tuple) else (a,)


@primitive("reduce_sum")
def sum(x, axis=None, keepdim=False, dtype=None, name=None):
    x = as_t(x)
    dt = tdtype(dtype)
    if dt is None and x.dtype == torch.bool:
        dt = torch.int64
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdim, dtype=dt)


@primitive("reduce_mean")
def mean(x, axis=None, keepdim=False, name=None):
    x = float_of(as_t(x))
    return torch.mean(x, dim=_dims(x, axis), keepdim=keepdim)


@primitive("reduce_max")
def max(x, axis=None, keepdim=False, name=None):
    x = as_t(x)
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)


@primitive("reduce_min")
def min(x, axis=None, keepdim=False, name=None):
    x = as_t(x)
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)


def _over(x, axis, keepdim, f):
    """``f(x, dim)`` for a single dim at a time over ``axis`` (torch ops
    that take one dim): the dims are moved last and flattened."""
    dims = _dims(x, axis)
    if x.dim() == 0:
        return f(x.reshape(1), 0).reshape(())
    nd = x.dim()
    dims = sorted(d % nd for d in dims)
    rest = [d for d in range(nd) if d not in dims]
    y = x.permute(*rest, *dims).reshape(*[x.shape[d] for d in rest], -1)
    out = f(y, -1)
    if keepdim:
        shape = [1 if d in dims else x.shape[d] for d in range(nd)]
        out = out.reshape(shape)
    return out


@primitive("reduce_prod")
def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    x = as_t(x)
    dt = tdtype(dtype)
    if dt is not None:
        x = x.to(dt)
    return _over(x, axis, keepdim, lambda y, d: torch.prod(y, dim=d))


@primitive("reduce_any")
def any(x, axis=None, keepdim=False, name=None):
    x = as_t(x)
    return _over(x, axis, keepdim, lambda y, d: torch.any(y, dim=d))


@primitive("reduce_all")
def all(x, axis=None, keepdim=False, name=None):
    x = as_t(x)
    return _over(x, axis, keepdim, lambda y, d: torch.all(y, dim=d))


@primitive("logsumexp")
def logsumexp(x, axis=None, keepdim=False, name=None):
    x = float_of(as_t(x))
    return torch.logsumexp(x, dim=_dims(x, axis), keepdim=keepdim)


@primitive("nansum")
def nansum(x, axis=None, keepdim=False, name=None):
    x = as_t(x)
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdim)


@primitive("nanmean")
def nanmean(x, axis=None, keepdim=False, name=None):
    x = float_of(as_t(x))
    return torch.nanmean(x, dim=_dims(x, axis), keepdim=keepdim)


@primitive("std")
def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = float_of(as_t(x))
    return torch.std(x, dim=_dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


@primitive("var")
def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = float_of(as_t(x))
    return torch.var(x, dim=_dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=keepdim)


@primitive("median")
def median(x, axis=None, keepdim=False, name=None):
    x = float_of(as_t(x))
    return _over(x, axis, keepdim,
                 lambda y, d: torch.quantile(y, 0.5, dim=d))


@primitive("quantile")
def quantile(x, q, axis=None, keepdim=False, name=None):
    x = float_of(as_t(x))
    qt = as_t(q, x, dtype=x.dtype) if not isinstance(q, torch.Tensor) \
        else q.to(x.dtype)
    out = _over(x, axis, keepdim,
                lambda y, d: torch.quantile(y, qt.reshape(-1), dim=d))
    # torch puts q's axis first; jnp.quantile too; a scalar q drops it
    return out[0] if qt.dim() == 0 else out


@primitive("cumsum")
def cumsum(x, axis=None, dtype=None, name=None):
    x = as_t(x)
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    return torch.cumsum(x, dim=int(axis), dtype=tdtype(dtype))


@primitive("cumprod")
def cumprod(x, dim=None, dtype=None, name=None):
    x = as_t(x)
    if dim is None:
        x = x.reshape(-1)
        dim = 0
    return torch.cumprod(x, dim=int(dim), dtype=tdtype(dtype))


@primitive("cummax")
def _cummax_raw(x, axis):
    return torch.cummax(x, dim=axis).values


@entry
def cummax(x, axis=None, name=None):
    x = as_t(x)
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    return _cummax_raw(x, axis=axis)


@primitive("cummin")
def _cummin_raw(x, axis):
    return torch.cummin(x, dim=axis).values


@entry
def cummin(x, axis=None, name=None):
    x = as_t(x)
    if axis is None:
        x = x.reshape(-1)
        axis = 0
    return _cummin_raw(x, axis=axis)


@primitive("count_nonzero")
def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = as_t(x)
    return torch.sum(x != 0, dim=_dims(x, axis), keepdim=keepdim)


@primitive("amax")
def amax(x, axis=None, keepdim=False, name=None):
    x = as_t(x)
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdim)


@primitive("amin")
def amin(x, axis=None, keepdim=False, name=None):
    x = as_t(x)
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdim)


@primitive("diff")
def diff(x, n=1, axis=-1, name=None):
    return torch.diff(as_t(x), n=n, dim=axis)


@primitive("trace_op")
def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(as_t(x), offset, axis1, axis2).sum(-1)


@primitive("kron")
def kron(x, y, name=None):
    return torch.kron(*pair(x, y))


@primitive("inner")
def inner(x, y, name=None):
    return torch.inner(*pair(x, y))


@primitive("outer")
def outer(x, y, name=None):
    x, y = pair(x, y)
    return torch.outer(x.reshape(-1), y.reshape(-1))


@primitive("dot_op")
def dot(x, y, name=None):
    x, y = pair(x, y)
    return torch.sum(x * y, dim=-1)


@primitive("addmm")
def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * as_t(input) + alpha * torch.matmul(*pair(x, y))


# -- bitwise -----------------------------------------------------------------
@primitive("bitwise_and")
def bitwise_and(x, y, name=None):
    return torch.bitwise_and(*pair(x, y))


@primitive("bitwise_or")
def bitwise_or(x, y, name=None):
    return torch.bitwise_or(*pair(x, y))


@primitive("bitwise_xor")
def bitwise_xor(x, y, name=None):
    return torch.bitwise_xor(*pair(x, y))


@primitive("bitwise_not")
def bitwise_not(x, name=None):
    return torch.bitwise_not(as_t(x))


@primitive("shift_left")
def shift_left(x, y, name=None):
    return torch.bitwise_left_shift(*pair(x, y))


@primitive("shift_right")
def shift_right(x, y, name=None):
    return torch.bitwise_right_shift(*pair(x, y))


@entry
def increment(x, value=1.0, name=None):
    with torch.no_grad():
        x.add_(torch.tensor(value, dtype=x.dtype, device=x.device))
    return x


@entry
def accuracy_op(pred, label, k=1):
    p, lab = as_t(pred), as_t(label)
    topk = torch.argsort(-p, dim=-1, stable=True)[..., :k]
    correct = torch.any(topk == lab.reshape(-1, 1), dim=-1)
    return torch.mean(correct.to(torch.float32))


@primitive("nanmedian")
def nanmedian(x, axis=None, keepdim=False, name=None):
    x = float_of(as_t(x))
    return _over(x, axis, keepdim,
                 lambda y, d: torch.nanquantile(y, 0.5, dim=d))


@primitive("rad2deg")
def rad2deg(x, name=None):
    return torch.rad2deg(float_of(as_t(x)))


@primitive("deg2rad")
def deg2rad(x, name=None):
    return torch.deg2rad(float_of(as_t(x)))


@primitive("ldexp")
def ldexp(x, y, name=None):
    x, y = pair(x, y)
    return torch.ldexp(float_of(x), y)


@primitive("polygamma", nondiff=("n",))
def polygamma(x, n, name=None):
    return torch.special.polygamma(int(n), float_of(as_t(x)))


@primitive("trapezoid")
def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = as_t(y)
    if x is not None:
        return torch.trapezoid(y, as_t(x, y), dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


@primitive("multiplex", nondiff=("index",))
def multiplex(inputs, index, name=None):
    stacked = torch.stack([as_t(t) for t in inputs], dim=0)
    idx = as_t(index).reshape(-1).to(torch.int64)
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[idx, rows]


@entry
def has_inf(x, name=None):
    return torch.isinf(as_t(x)).any()


@entry
def has_nan(x, name=None):
    return torch.isnan(as_t(x)).any()


@primitive("clip_by_norm")
def clip_by_norm(x, max_norm, name=None):
    x = as_t(x)
    norm = torch.sqrt(torch.sum(torch.square(x)))
    m = torch.tensor(max_norm, dtype=x.dtype, device=x.device)
    return x * (m / torch.maximum(norm, m))


@primitive("cos_sim")
def cos_sim(X, Y, name=None):
    X, Y = pair(X, Y)
    xn = torch.sqrt(torch.sum(torch.square(X), dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(torch.square(Y), dim=-1, keepdim=True))
    d = torch.sum(X * Y, dim=-1, keepdim=True)
    return d / torch.clamp_min(xn * yn, 1e-12)


_U32 = 0xFFFFFFFF


@primitive("hash_op", nondiff=("num_hash", "mod_by"))
def hash_(x, num_hash=1, mod_by=2 ** 31 - 1, name=None):
    """The JAX op's multiplicative mixer, in uint32 arithmetic carried in
    int64 (``& 0xFFFFFFFF`` after every product)."""
    x = as_t(x).to(torch.int64) & _U32
    seeds = (torch.arange(1, num_hash + 1, dtype=torch.int64,
                          device=x.device) * 0x9E3779B1) & _U32
    h = (x[..., None] * seeds) & _U32
    h = h ^ (h >> 15)
    h = (h * 0x85EBCA6B) & _U32
    h = h ^ (h >> 13)
    return h % (mod_by & _U32)


@primitive("add_position_encoding")
def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    x = as_t(input)
    b, L, d = x.shape
    half = d // 2
    pos = torch.arange(L, dtype=torch.float32, device=x.device)[:, None]
    denom = half - 1 if half > 1 else 1
    div = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                    * -(_pymath.log(10000.0) / denom))
    enc = torch.cat([torch.sin(pos * div), torch.cos(pos * div)], dim=1)
    if enc.shape[1] < d:
        enc = torch.nn.functional.pad(enc, (0, d - enc.shape[1]))
    return alpha * x + beta * enc[None, :, :].to(x.dtype)


del _b_max

__all__ = sorted(set(_UNARY) | set(_BINARY) | {
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_pow", "elementwise_max",
    "elementwise_min", "elementwise_mod", "floor_mod", "scale", "clip",
    "lerp", "stanh", "logit", "log_sigmoid", "isnan", "isinf", "isfinite",
    "nan_to_num", "cast", "sum", "mean", "max", "min", "prod", "any", "all",
    "logsumexp", "nansum", "nanmean", "std", "var", "median", "quantile",
    "cumsum", "cumprod", "cummax", "cummin", "count_nonzero", "amax", "amin",
    "diff", "trace", "kron", "inner", "outer", "dot", "addmm", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "shift_left", "shift_right",
    "increment", "accuracy_op", "nanmedian", "rad2deg", "deg2rad", "ldexp",
    "polygamma", "trapezoid", "multiplex", "has_inf", "has_nan",
    "clip_by_norm", "cos_sim", "hash_", "add_position_encoding"})
