"""Graph-building layer functions for static programs.

Port of the part of ``paddle_tpu/static/layers.py`` that
``examples/train_resnet_static.py``'s network and the static optimizers
use. Each function appends OpDescs to the current program and returns
Variables; names come from ``utils.unique_name`` with the JAX package's
keys, so a program built by both packages under ``unique_name.guard()``
is the same program, op for op and var for var.

Shape inference is not written per op: ``_infer_outputs`` runs the op's
kernel on ``torch.device("meta")`` tensors (shapes and dtypes, no data),
the counterpart of the JAX package's ``jax.eval_shape``, with the same
sentinel for a dynamic dimension.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..framework import dtype as dtype_mod
from ..utils import unique_name
from .ir import (Block, ParamDesc, Variable, _DYN_SENTINEL,
                 default_main_program, default_startup_program)
from .kernels import KERNELS, ExecContext

__all__ = ["LayerHelper", "data", "fill_constant", "fc", "conv2d", "pool2d",
           "batch_norm", "matmul", "mul", "elementwise_add",
           "elementwise_sub", "elementwise_mul", "elementwise_div",
           "elementwise_max", "elementwise_min", "scale", "cast",
           "mean", "reshape", "flatten", "relu", "sigmoid", "tanh", "exp",
           "log", "sqrt", "square", "abs", "softmax", "cross_entropy",
           "softmax_with_cross_entropy", "accuracy", "increment",
           "create_parameter"]

_META = torch.device("meta")


# ---------------------------------------------------------------------------
# shape inference on the meta device
# ---------------------------------------------------------------------------
def _infer_outputs(block: Block, op):
    """Create output vars of ``op`` with the shapes and dtypes its kernel
    gives on meta tensors."""
    kernel = KERNELS.get(op.type)
    if kernel is None:
        raise NotImplementedError(
            f"static op {op.type!r} is not in this port slice; a later "
            "port slice adds it")
    ins = {}
    for slot, names in op.inputs.items():
        arrs = []
        for n in names:
            desc = block._find_var_recursive(n)
            # -k encodes "dynamic batch times static k", so a
            # flatten/reshape round-trip keeps its static factor
            shape = tuple(_DYN_SENTINEL * (1 if s is None else -s)
                          if (s is None or s < 0) else s
                          for s in (desc.shape or ()))
            arrs.append(torch.empty(shape, dtype=dtype_mod.to_torch(
                desc.dtype), device=_META))
        ins[slot] = arrs
    with torch.no_grad():
        outs = kernel(ins, op.attrs, ExecContext(device=_META))
    created = {}
    for slot, names in op.outputs.items():
        for name, t in zip(names, outs.get(slot, [])):
            shape = tuple(-(s // _DYN_SENTINEL) if (s >= _DYN_SENTINEL and
                                                    s % _DYN_SENTINEL == 0)
                          else s for s in t.shape)
            if not block.has_var(name):
                block.create_var(name=name, shape=shape,
                                 dtype=dtype_mod.dtype_name(t.dtype))
            created[name] = block.var(name)
    return created


class LayerHelper:
    """Append-op helper: the current program's block, and parameters
    created in the main program with their init op in the startup
    program."""

    def __init__(self, layer_type: str, **kwargs):
        self.layer_type = layer_type
        self.main_program = default_main_program()
        self.startup_program = default_startup_program()

    @property
    def block(self) -> Block:
        return self.main_program.current_block()

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        op = self.block.append_op(type=type, inputs=inputs, outputs=outputs,
                                  attrs=attrs)
        if infer_shape:
            _infer_outputs(self.block, op)
        return op

    def create_parameter(self, shape, dtype="float32", name=None,
                         initializer=None, trainable=True,
                         attr=None):
        """A ParamDesc in the main block and its init op in the startup
        program."""
        from .initializer import resolve_initializer

        if attr is not None and getattr(attr, "name", None):
            name = attr.name
        if attr is not None and getattr(attr, "initializer", None) is not None:
            initializer = attr.initializer
        if attr is not None and getattr(attr, "trainable", None) is not None:
            trainable = attr.trainable
        name = name or unique_name.generate(f"{self.layer_type}_w")
        shape = tuple(int(s) for s in shape)
        desc = ParamDesc(name, shape, dtype_mod.dtype_name(
            dtype_mod.convert_dtype(dtype)), trainable=trainable)
        self.main_program.global_block.vars[name] = desc

        op_type, attrs = resolve_initializer(initializer, shape, desc.dtype,
                                             fan_hint=shape)
        desc.initializer_desc = [op_type, attrs]
        sb = self.startup_program.global_block
        sb.vars[name] = ParamDesc(name, shape, desc.dtype, trainable)
        sb.append_op(type=op_type, inputs={}, outputs={"Out": [name]},
                     attrs=attrs)
        return Variable(self.main_program.global_block, desc)


def _append_simple(op_type, inputs, attrs=None, out_slots=("Out",),
                   helper=None):
    helper = helper or LayerHelper(op_type)
    outputs = {slot: [unique_name.generate(f"{op_type}.{slot.lower()}")]
               for slot in out_slots}
    op = helper.block.append_op(type=op_type, inputs=inputs,
                                outputs=outputs, attrs=attrs or {})
    _infer_outputs(helper.block, op)
    outs = [helper.block.var(outputs[s][0]) for s in out_slots]
    return outs[0] if len(outs) == 1 else tuple(outs)


# ---------------------------------------------------------------------------
# data & constants
# ---------------------------------------------------------------------------
def data(name: str, shape: Sequence[int], dtype="float32",
         lod_level=0, append_batch_size=False) -> Variable:
    """Feed placeholder; -1 marks a dynamic dimension."""
    prog = default_main_program()
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return prog.global_block.create_var(
        name=name, shape=shape, dtype=dtype, is_data=True,
        stop_gradient=True)


def fill_constant(shape, dtype, value, name=None):
    helper = LayerHelper("fill_constant")
    out_name = name or unique_name.generate("fill_constant.out")
    op = helper.block.append_op(
        type="fill_constant", inputs={},
        outputs={"Out": [out_name]},
        attrs={"shape": list(shape), "dtype": str(dtype), "value": value})
    _infer_outputs(helper.block, op)
    return helper.block.var(out_name)


# ---------------------------------------------------------------------------
# core NN layers
# ---------------------------------------------------------------------------
def _bias_default():
    """Bias initializer default: the set_global_initializer bias slot if
    set, else zeros."""
    from .initializer import Constant, _global_initializer

    return _global_initializer[1] or Constant(0.0)


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """flatten -> mul -> add bias -> act."""
    helper = LayerHelper("fc", name=name)
    fan_in = 1
    for s in input.shape[num_flatten_dims:]:
        fan_in *= (s if s and s > 0 else 1)
    w = helper.create_parameter((fan_in, size), input.dtype, attr=param_attr,
                                initializer=None)
    out = _append_simple("mul", {"X": [input], "Y": [w]},
                         {"x_num_col_dims": num_flatten_dims,
                          "y_num_col_dims": 1}, helper=helper)
    if bias_attr is not False:
        b = helper.create_parameter((size,), input.dtype, attr=bias_attr,
                                    initializer=_bias_default())
        out = _append_simple("elementwise_add", {"X": [out], "Y": [b]},
                             {"axis": len(out.shape) - 1}, helper=helper)
    if act:
        out = _append_simple(act, {"X": [out]}, helper=helper)
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("conv2d", name=name)
    if isinstance(filter_size, int):
        filter_size = (filter_size, filter_size)
    stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
    padding = (padding, padding) if isinstance(padding, int) \
        else tuple(padding)
    dilation = (dilation, dilation) if isinstance(dilation, int) \
        else tuple(dilation)
    c_in = input.shape[1]
    w = helper.create_parameter(
        (num_filters, c_in // groups) + tuple(filter_size), input.dtype,
        attr=param_attr)
    out = _append_simple(
        "conv2d", {"Input": [input], "Filter": [w]},
        {"strides": list(stride), "paddings": list(padding),
         "dilations": list(dilation), "groups": groups},
        out_slots=("Output",), helper=helper)
    if bias_attr is not False:
        b = helper.create_parameter((num_filters,), input.dtype,
                                    attr=bias_attr,
                                    initializer=_bias_default())
        out = _append_simple("elementwise_add", {"X": [out], "Y": [b]},
                             {"axis": 1}, helper=helper)
    if act:
        out = _append_simple(act, {"X": [out]}, helper=helper)
    return out


def pool2d(input, pool_size=2, pool_type="max", pool_stride=None,
           pool_padding=0, global_pooling=False, exclusive=True, name=None):
    if isinstance(pool_size, int):
        pool_size = (pool_size, pool_size)
    pool_stride = pool_stride or pool_size
    if isinstance(pool_stride, int):
        pool_stride = (pool_stride, pool_stride)
    if isinstance(pool_padding, int):
        pool_padding = (pool_padding, pool_padding)
    return _append_simple(
        "pool2d", {"X": [input]},
        {"ksize": list(pool_size), "pooling_type": pool_type,
         "strides": list(pool_stride), "paddings": list(pool_padding),
         "global_pooling": global_pooling, "exclusive": exclusive})


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, name=None):
    helper = LayerHelper("batch_norm", name=name)
    c = input.shape[1]
    from .initializer import Constant
    scale = helper.create_parameter((c,), input.dtype, attr=param_attr,
                                    initializer=Constant(1.0))
    bias = helper.create_parameter((c,), input.dtype, attr=bias_attr,
                                   initializer=_bias_default())
    # running statistics, not biases: never subject to the global
    # bias initializer (mean starts at 0, variance at 1)
    mean = helper.create_parameter((c,), input.dtype,
                                   initializer=Constant(0.0),
                                   trainable=False)
    var = helper.create_parameter((c,), input.dtype,
                                  initializer=Constant(1.0),
                                  trainable=False)
    outs = {s: [unique_name.generate(f"bn.{s.lower()}")]
            for s in ("Y", "SavedMean", "SavedVariance")}
    outs["MeanOut"] = [mean.name]
    outs["VarianceOut"] = [var.name]
    op = helper.block.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [var]},
        outputs=outs,
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test})
    _infer_outputs(helper.block, op)
    out = helper.block.var(outs["Y"][0])
    if act:
        out = _append_simple(act, {"X": [out]}, helper=helper)
    return out


# ---------------------------------------------------------------------------
# math / tensor ops
# ---------------------------------------------------------------------------
def _elementwise_binary(x, y, op_type, reverse=False):
    if not isinstance(y, Variable):
        y = fill_constant(shape=(1,), dtype=x.dtype, value=float(y))
    if not isinstance(x, Variable):
        x = fill_constant(shape=(1,), dtype=y.dtype, value=float(x))
    if reverse:
        x, y = y, x
    return _append_simple(op_type, {"X": [x], "Y": [y]}, {"axis": -1})


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    return _append_simple("matmul", {"X": [x], "Y": [y]},
                          {"transpose_X": transpose_x,
                           "transpose_Y": transpose_y, "alpha": alpha})


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    return _append_simple("mul", {"X": [x], "Y": [y]},
                          {"x_num_col_dims": x_num_col_dims,
                           "y_num_col_dims": y_num_col_dims})


def elementwise_add(x, y, axis=-1, act=None, name=None):
    out = _append_simple("elementwise_add", {"X": [x], "Y": [y]},
                         {"axis": axis})
    return _append_simple(act, {"X": [out]}) if act else out


# As in the JAX package, only elementwise_add applies ``act``; the others
# take it and build the same program the JAX layers build.
def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _append_simple("elementwise_sub", {"X": [x], "Y": [y]},
                          {"axis": axis})


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _append_simple("elementwise_mul", {"X": [x], "Y": [y]},
                          {"axis": axis})


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _append_simple("elementwise_div", {"X": [x], "Y": [y]},
                          {"axis": axis})


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _append_simple("elementwise_max", {"X": [x], "Y": [y]},
                          {"axis": axis})


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _append_simple("elementwise_min", {"X": [x], "Y": [y]},
                          {"axis": axis})


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    out = _append_simple("scale", {"X": [x]},
                         {"scale": float(scale), "bias": float(bias),
                          "bias_after_scale": bias_after_scale})
    return _append_simple(act, {"X": [out]}) if act else out


def cast(x, dtype):
    return _append_simple("cast", {"X": [x]}, {"out_dtype": str(
        dtype_mod.dtype_name(dtype_mod.convert_dtype(dtype)))})


def mean(x, name=None):
    return _append_simple("mean", {"X": [x]})


def reshape(x, shape, name=None):
    return _append_simple("reshape2", {"X": [x]}, {"shape": list(shape)})


def flatten(x, axis=1, name=None):
    return _append_simple("flatten2", {"X": [x]}, {"axis": axis})


def _act_layer(name):
    def f(x, **kwargs):
        return _append_simple(name, {"X": [x]})
    f.__name__ = name
    return f


relu = _act_layer("relu")
sigmoid = _act_layer("sigmoid")
tanh = _act_layer("tanh")
exp = _act_layer("exp")
log = _act_layer("log")
sqrt = _act_layer("sqrt")
square = _act_layer("square")
abs = _act_layer("abs")


def softmax(input, axis=-1, name=None):
    return _append_simple("softmax", {"X": [input]}, {"axis": axis})


# losses & metrics
def cross_entropy(input, label, soft_label=False, name=None):
    return _append_simple("cross_entropy",
                          {"X": [input], "Label": [label]},
                          {"soft_label": soft_label}, out_slots=("Y",))


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               return_softmax=False, axis=-1):
    sm, loss = _append_simple(
        "softmax_with_cross_entropy",
        {"Logits": [logits], "Label": [label]},
        {"soft_label": soft_label}, out_slots=("Softmax", "Loss"))
    return (loss, sm) if return_softmax else loss


def accuracy(input, label, k=1, name=None):
    acc, _, _ = _append_simple(
        "accuracy", {"Out": [input], "Label": [label]}, {"k": k},
        out_slots=("Accuracy", "Correct", "Total"))
    return acc


def increment(x, value=1.0, in_place=True):
    """x + value keeping dtype; ``in_place`` (the default) writes back
    to x's own variable."""
    helper = LayerHelper("increment")
    if in_place:
        helper.block.append_op(type="increment", inputs={"X": [x]},
                               outputs={"Out": [x.name]},
                               attrs={"step": value})
        return helper.block.var(x.name)
    return _append_simple("increment", {"X": [x]}, {"step": value})


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A standalone parameter."""
    helper = LayerHelper("create_parameter")
    return helper.create_parameter(shape, dtype, name=name,
                                   initializer=default_initializer,
                                   attr=attr)
