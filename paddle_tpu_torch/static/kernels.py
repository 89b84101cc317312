"""Static-graph op kernels: op_type -> a torch function over named slots.

Port of ``paddle_tpu/static/kernels.py``, cut to the ops that
``examples/train_resnet_static.py``'s network, its optimizers and their
startup programs use. Signature, as in the JAX package:
``fn(ins: {slot: [tensor]}, attrs, ctx: ExecContext) -> {slot:
[tensor]}``. The executor interprets a block op by op (``executor.py``),
so each kernel runs eagerly on the op's device; ``ctx.device`` is
``meta`` when ``layers._infer_outputs`` runs a kernel for shapes only.

Kernels are pure except the optimizer updates (``sgd``, ``momentum``,
``adam``, ``lamb``), which update the parameter and its accumulators IN
PLACE through K3's static forms (``ops/cuda/fused_optimizer.py``) and
return them; the executor runs them under ``torch.no_grad()``, after the
backward op. The updates are also registered in ``GROUP_KERNELS`` as
kernels of a RUN of ops, ``fn(ins_list, attrs, ctx) -> outs_list``:
the executor hands them each maximal run of consecutive updates of one
type and attrs (``executor.op_runs``), one launch for the run.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..framework import dtype as dtype_mod
from ..framework.random import fold_in
from ..ops.cuda import fused_optimizer as fo

KERNELS: Dict[str, Callable] = {}
#: op_type -> the kernel of a run of such ops (the executor's grouping)
GROUP_KERNELS: Dict[str, Callable] = {}


@dataclass
class ExecContext:
    """What a kernel needs besides its inputs: the device its outputs go
    to, the random seed and the op's index (which keys the op's random
    stream)."""
    device: torch.device = torch.device("cpu")
    seed: int = 0
    op_index: int = 0

    def generator(self):
        """A generator on ``device`` seeded from ``(seed, op_index)``
        (``jax.random.fold_in(key, op_index)`` in the JAX package; the
        bits differ). None on the meta device, which draws nothing."""
        if self.device.type == "meta":
            return None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(fold_in(self.seed, self.op_index) & ((1 << 63) - 1))
        return gen


def kernel(op_type):
    def deco(fn):
        KERNELS[op_type] = fn
        fn.op_type = op_type
        return fn
    return deco


def _x(ins, slot="X"):
    return ins[slot][0]


def _dt(name):
    return dtype_mod.to_torch(name)


def _out(*arrays, slot="Out"):
    return {slot: list(arrays)}


def _prod(t):
    r = 1
    for v in t:
        r *= int(v)
    return r


# ---------------------------------------------------------------------------
# creation / initialization (startup-program ops)
# ---------------------------------------------------------------------------
@kernel("fill_constant")
def _fill_constant(ins, attrs, ctx):
    return _out(torch.full(tuple(attrs["shape"]), attrs["value"],
                           dtype=_dt(attrs["dtype"]), device=ctx.device))


@kernel("gaussian_random")
def _gaussian_random(ins, attrs, ctx):
    z = torch.randn(tuple(attrs["shape"]), generator=ctx.generator(),
                    dtype=_dt(attrs.get("dtype", "float32")),
                    device=ctx.device)
    return _out(attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z)


@kernel("uniform_random")
def _uniform_random(ins, attrs, ctx):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = torch.rand(tuple(attrs["shape"]), generator=ctx.generator(),
                   dtype=_dt(attrs.get("dtype", "float32")),
                   device=ctx.device)
    return _out(u * (hi - lo) + lo)


@kernel("truncated_gaussian_random")
def _trunc_gaussian(ins, attrs, ctx):
    """mean + std * a standard normal truncated to (-2, 2), by the
    inverse CDF (``jax.random.truncated_normal(key, -2, 2)``)."""
    lo, hi = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0, \
        (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    u = torch.rand(tuple(attrs["shape"]), generator=ctx.generator(),
                   dtype=_dt(attrs.get("dtype", "float32")),
                   device=ctx.device)
    z = torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0) * math.sqrt(2.0)
    z = torch.clamp(z, -2.0, 2.0)
    return _out(attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z)


@kernel("assign_value")
def _assign_value(ins, attrs, ctx):
    vals = np.asarray(attrs["values"], dtype=attrs.get("dtype", "float32"))
    return _out(torch.as_tensor(vals.reshape(tuple(attrs["shape"])),
                                device=ctx.device))


# ---------------------------------------------------------------------------
# elementwise: numpy broadcasting; the `axis` attr aligns a lower-rank Y
# at a given axis of X
# ---------------------------------------------------------------------------
def _align(x, y, axis):
    if axis in (None, -1) or y.dim() == x.dim():
        return y
    return y.reshape(tuple(y.shape) + (1,) * (x.dim() - axis - y.dim()))


def _ew(op_type, fn):
    @kernel(op_type)
    def k(ins, attrs, ctx, _fn=fn):
        x, y = _x(ins), ins["Y"][0]
        return _out(_fn(x, _align(x, y, attrs.get("axis", -1))))
    return k


_ew("elementwise_add", torch.add)
_ew("elementwise_sub", torch.sub)
_ew("elementwise_mul", torch.mul)
_ew("elementwise_div", torch.div)
_ew("elementwise_max", torch.maximum)
_ew("elementwise_min", torch.minimum)
_ew("elementwise_pow", torch.pow)


@kernel("scale")
def _scale(ins, attrs, ctx):
    x = _x(ins)
    s, b = attrs.get("scale", 1.0), attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return _out(x * s + b)
    return _out((x + b) * s)


@kernel("cast")
def _cast(ins, attrs, ctx):
    return _out(_x(ins).to(_dt(attrs["out_dtype"])))


def _unary(op_type, fn):
    @kernel(op_type)
    def k(ins, attrs, ctx, _fn=fn):
        return _out(_fn(_x(ins)))
    return k


_unary("relu", torch.relu)
_unary("sigmoid", torch.sigmoid)
_unary("tanh", torch.tanh)
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("sqrt", torch.sqrt)
_unary("square", torch.square)
_unary("abs", torch.abs)
_unary("sign", torch.sign)


# ---------------------------------------------------------------------------
# matmul / mul, reductions, shapes
# ---------------------------------------------------------------------------
@kernel("matmul")
def _matmul(ins, attrs, ctx):
    x, y = _x(ins), ins["Y"][0]
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return _out(out)


@kernel("mul")
def _mul(ins, attrs, ctx):
    """Flattening matmul: x flattened to 2-D at x_num_col_dims, y at
    y_num_col_dims."""
    x, y = _x(ins), ins["Y"][0]
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(-1, _prod(xs[xnc:]))
    y2 = y.reshape(_prod(ys[:ync]), -1)
    return _out((x2 @ y2).reshape(xs[:xnc] + ys[ync:]))


@kernel("mean")
def _mean(ins, attrs, ctx):
    return _out(torch.mean(_x(ins)))


@kernel("reshape2")
def _reshape(ins, attrs, ctx):
    x = _x(ins)
    # 0 copies the input's dim, -1 is inferred
    shape = [x.shape[i] if int(s) == 0 else int(s)
             for i, s in enumerate(attrs["shape"])]
    return _out(torch.reshape(x, shape))


@kernel("flatten2")
def _flatten(ins, attrs, ctx):
    x = _x(ins)
    return _out(x.reshape(_prod(x.shape[:attrs.get("axis", 1)]), -1))


# ---------------------------------------------------------------------------
# NN ops
# ---------------------------------------------------------------------------
@kernel("softmax")
def _softmax(ins, attrs, ctx):
    return _out(torch.softmax(_x(ins), dim=attrs.get("axis", -1)))


@kernel("cross_entropy")
def _cross_entropy(ins, attrs, ctx):
    x, label = _x(ins), ins["Label"][0]
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * torch.log(x + 1e-12), dim=-1,
                          keepdim=True)
    else:
        idx = label.long().reshape(tuple(label.shape[:1]) + (1,))
        loss = -torch.log(torch.gather(x, -1, idx) + 1e-12)
    return _out(loss, slot="Y")


@kernel("softmax_with_cross_entropy")
def _softmax_ce(ins, attrs, ctx):
    logits, label = ins["Logits"][0], ins["Label"][0]
    logp = torch.log_softmax(logits, dim=-1)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
    else:
        lab = label.long()
        if lab.dim() == logits.dim():
            lab = lab[..., 0]
        loss = -torch.gather(logp, -1, lab[..., None])
    return {"Softmax": [torch.exp(logp)], "Loss": [loss]}


@kernel("accuracy")
def _accuracy(ins, attrs, ctx):
    pred, label = _x(ins, "Out"), ins["Label"][0]
    _, topk_idx = torch.topk(pred, attrs.get("k", 1), dim=-1)
    lab = label.reshape(pred.shape[0], 1).to(topk_idx.dtype)
    correct = (topk_idx == lab).any(dim=-1).sum()
    total = torch.full((), pred.shape[0], dtype=torch.int32,
                       device=pred.device)
    # a true division (not a reciprocal multiply), as jnp divides
    acc = correct.to(torch.float32) / total.to(torch.float32)
    return {"Accuracy": [acc], "Correct": [correct.to(torch.int32)],
            "Total": [total]}


@kernel("conv2d")
def _conv2d(ins, attrs, ctx):
    """NCHW input, OIHW filter; ``paddings`` (ph, pw) or (top, bottom,
    left, right). cuDNN does the product (the JAX package leaves it to
    ``lax.conv_general_dilated``, not to a Pallas kernel)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    pad = list(attrs.get("paddings", [0, 0]))
    if len(pad) == 4 and (pad[0] != pad[1] or pad[2] != pad[3]):
        x = F.pad(x, (pad[2], pad[3], pad[0], pad[1]))
        pad = [0, 0]
    elif len(pad) == 4:
        pad = [pad[0], pad[2]]
    out = F.conv2d(x, w, None, tuple(attrs.get("strides", [1, 1])),
                   tuple(pad), tuple(attrs.get("dilations", [1, 1])),
                   attrs.get("groups", 1))
    return _out(out, slot="Output")


@kernel("pool2d")
def _pool2d(ins, attrs, ctx):
    """Max or average pooling. Average: exclusive (the default) divides
    each window by the count of its elements inside the input, which is
    the window size unless there is padding."""
    x = _x(ins)
    ptype = attrs.get("pooling_type", "max")
    if attrs.get("global_pooling", False):
        if ptype == "max":
            return _out(torch.amax(x, dim=(2, 3), keepdim=True))
        return _out(torch.mean(x, dim=(2, 3), keepdim=True))
    k = tuple(attrs["ksize"])
    s = tuple(attrs.get("strides", k))
    p = tuple(attrs.get("paddings", [0, 0]))
    if ptype == "max":
        return _out(F.max_pool2d(x, k, s, p))
    return _out(F.avg_pool2d(x, k, s, p, count_include_pad=not attrs.get(
        "exclusive", True)))


@kernel("batch_norm")
def _batch_norm(ins, attrs, ctx):
    """Training: the batch's mean and BIASED variance over (N, H, W),
    running statistics ``momentum*old + (1-momentum)*batch`` (Paddle's
    convention). ``is_test`` (set by ``clone(for_test=True)``): the
    running ones."""
    x = _x(ins)
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    axis = tuple(i for i in range(x.dim()) if i != 1)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if attrs.get("is_test", False):
        y = (x - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + eps) * scale.reshape(shape) + \
            bias.reshape(shape)
        return {"Y": [y], "MeanOut": [mean], "VarianceOut": [var],
                "SavedMean": [mean], "SavedVariance": [var]}
    bmean = torch.mean(x, dim=axis)
    bvar = torch.var(x, dim=axis, correction=0)
    y = (x - bmean.reshape(shape)) * torch.rsqrt(
        bvar.reshape(shape) + eps) * scale.reshape(shape) + \
        bias.reshape(shape)
    # the statistics carry no gradient: they leave the step as state
    bmean, bvar = bmean.detach(), bvar.detach()
    new_mean = momentum * mean + (1 - momentum) * bmean
    new_var = momentum * var + (1 - momentum) * bvar
    return {"Y": [y], "MeanOut": [new_mean], "VarianceOut": [new_var],
            "SavedMean": [bmean], "SavedVariance": [bvar]}


# ---------------------------------------------------------------------------
# optimizer updates: K3's static forms, in place. An optional
# FoundInfinite input gates the whole update (params, moments and
# beta-pows keep their values), read by the kernel on the device.
# ---------------------------------------------------------------------------
def _found(ins):
    found = ins.get("FoundInfinite")
    return found[0] if found else None


def group_kernel(op_type):
    """Register ``fn(ins_list, attrs, ctx) -> outs_list`` as the kernel
    of a run of ``op_type`` ops (one ``ins`` dict an op, equal attrs),
    and its one-op form as the op's kernel."""
    def deco(fn):
        GROUP_KERNELS[op_type] = fn
        kernel(op_type)(lambda ins, attrs, ctx: fn([ins], attrs, ctx)[0])
        return fn
    return deco


def _slots(ins_list, slot):
    return [ins[slot][0] for ins in ins_list]


def _founds(ins_list):
    return [_found(ins) for ins in ins_list]


@group_kernel("sgd")
def _sgd(ins_list, attrs, ctx):
    ps = _slots(ins_list, "Param")
    fo.static_sgd_list_(ps, _slots(ins_list, "Grad"),
                        _slots(ins_list, "LearningRate"), _founds(ins_list))
    return [{"ParamOut": [p]} for p in ps]


@group_kernel("momentum")
def _momentum(ins_list, attrs, ctx):
    ps, vs = _slots(ins_list, "Param"), _slots(ins_list, "Velocity")
    fo.static_momentum_list_(ps, _slots(ins_list, "Grad"), vs,
                             _slots(ins_list, "LearningRate"),
                             mu=attrs.get("mu", 0.9),
                             nesterov=attrs.get("use_nesterov", False),
                             founds=_founds(ins_list))
    return [{"ParamOut": [p], "VelocityOut": [v]} for p, v in zip(ps, vs)]


def _adam_like(update, ins_list, attrs, **extra):
    ps = _slots(ins_list, "Param")
    ms, vs = _slots(ins_list, "Moment1"), _slots(ins_list, "Moment2")
    pows = update(ps, _slots(ins_list, "Grad"), ms, vs,
                  _slots(ins_list, "Beta1Pow"), _slots(ins_list, "Beta2Pow"),
                  _slots(ins_list, "LearningRate"),
                  beta1=attrs.get("beta1", 0.9),
                  beta2=attrs.get("beta2", 0.999),
                  founds=_founds(ins_list), **extra)
    return [{"ParamOut": [p], "Moment1Out": [m], "Moment2Out": [v],
             "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]}
            for p, m, v, (b1p, b2p) in zip(ps, ms, vs, pows)]


@group_kernel("adam")
def _adam(ins_list, attrs, ctx):
    return _adam_like(fo.static_adam_list_, ins_list, attrs,
                      eps=attrs.get("epsilon", 1e-8))


@group_kernel("lamb")
def _lamb(ins_list, attrs, ctx):
    return _adam_like(fo.static_lamb_list_, ins_list, attrs,
                      eps=attrs.get("epsilon", 1e-6),
                      weight_decay=attrs.get("weight_decay", 0.01))


@kernel("check_finite_and_unscale")
def _check_finite_and_unscale(ins, attrs, ctx):
    """Divide every grad by the loss scale and flag a non-finite value;
    on a flagged step the grads are zeroed and the update ops gated by
    FoundInfinite keep their state."""
    xs = list(ins.get("X", []))
    scale = ins["Scale"][0] if ins.get("Scale") else attrs.get("scale", 1.0)
    inv = 1.0 / scale
    found = torch.zeros((), dtype=torch.bool, device=ctx.device)
    for x in xs:
        found = found | (~torch.isfinite(x)).any()
    outs = [torch.where(found, torch.zeros_like(x), (x * inv).to(x.dtype))
            for x in xs]
    return {"Out": outs, "FoundInfinite": [found.reshape(1)]}


@kernel("increment")
def _increment(ins, attrs, ctx):
    x = _x(ins)
    return _out(x + torch.tensor(attrs.get("step", 1.0), dtype=x.dtype,
                                 device=x.device))
