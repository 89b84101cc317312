"""``Layer``: the port's module base, a :class:`torch.nn.Module` with the
JAX package's ``create_parameter``, ``ParamAttr`` and ``Parameter``;
and :func:`load_numpy_state`, which carries a JAX model's
``state_dict()`` (parameters and buffers) and its optimizer's into a
port model by name.

Port of ``paddle_tpu/nn/layer.py`` (``ParamAttr`` ``:23-61``,
``Parameter`` ``:64-100``, ``create_parameter``, ``to``,
``state_dict``/``set_state_dict`` ``:257-318``). Attribute names follow
the JAX layers, so ``state_dict()`` keys match the JAX model's one to
one (parameters of a layer first, then its sublayers', as both
frameworks walk them). Parameters are f32 unless ``dtype`` says
otherwise and are created on the layer's device (``device=None`` means
CUDA, via ``resolve_device``) from an explicit :class:`torch.Generator`
(default: the global generator of that device,
``framework.random.seed``).

Names follow the JAX rule: a layer is ``f"{class name lowered}_{n}"``
and its k-th parameter ``f"{layer}.w_{k}"``, from the counters of
``utils.unique_name`` (so a model built under ``unique_name.guard()``
by either package names its parameters alike); a deep copy keeps its
parameters' names, as the JAX ``Tensor`` does, so the layers that
``TransformerEncoder`` copies share them (optimizer checkpoints keyed
by name then hold one entry a name, in both packages).
``ParamAttr.learning_rate`` and ``need_clip`` are stored and not
applied, as in the JAX package; ``regularizer`` is read by the
optimizers (per-parameter precedence) and ``trainable=False`` makes a
parameter that needs no gradient.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..framework.dtype import to_torch
from ..framework.random import default_generator
from ..utils import unique_name
from . import initializer as I

__all__ = ["Layer", "ParamAttr", "Parameter", "load_numpy_state"]


class ParamAttr:
    """``name``, ``initializer``, ``learning_rate``, ``regularizer``,
    ``trainable`` and ``need_clip`` of a parameter (the JAX class)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """None, a ``ParamAttr``, False (no parameter: None), a name or
        an initializer as a ``ParamAttr``."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if attr is False:
            return None
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"Cannot interpret {attr!r} as ParamAttr")


class Parameter(torch.nn.Parameter):
    """A ``torch.nn.Parameter`` with the JAX parameter's attributes:
    ``name``, ``trainable`` (``requires_grad``), ``optimize_attr``
    (``{"learning_rate": ...}``), ``regularizer`` and ``need_clip``."""

    def __new__(cls, data=None, requires_grad=True):
        return super().__new__(cls, data, requires_grad)

    # torch's Tensor has a read-only ``name``; the JAX parameter's is a
    # plain attribute
    @property
    def name(self):
        return self.__dict__.get("_param_name")

    @name.setter
    def name(self, value):
        self.__dict__["_param_name"] = value

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.requires_grad_(bool(value))

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = type(self)(self.data.clone(memory_format=torch.preserve_format),
                         self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update({k: v for k, v in self.__dict__.items()
                             if k != "_param_name"})
        out.name = self.name
        return out


class Layer(torch.nn.Module):
    """Module base. A layer with parameters takes ``device`` and
    ``generator`` in its constructor and hands them to
    :meth:`create_parameter`; neither is kept on the layer."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = to_torch(dtype)
        self._full_name = unique_name.next_name(
            name_scope or type(self).__name__.lower())

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, device=None,
                         generator=None):
        """A parameter on ``device`` (None: CUDA) of ``dtype`` (None:
        the layer's, f32), or None for ``attr=False``:
        ``attr.initializer``, else ``default_initializer``, else zeros
        for a bias and Xavier-uniform otherwise (the JAX defaults), drawn
        from ``generator`` (None: the device's global generator)."""
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        init = attr.initializer or default_initializer or (
            I.Constant(0.0) if is_bias else I.XavierUniform())
        device = resolve_device(device)
        gen = generator if generator is not None \
            else default_generator(device)
        value = init(tuple(int(s) for s in shape), device, gen)
        dt = to_torch(dtype) if dtype is not None else self._dtype
        p = Parameter(value.to(dt), requires_grad=attr.trainable)
        p.name = attr.name or unique_name.next_name(self._full_name + ".w")
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def to(self, *args, **kwargs):
        """``torch.nn.Module.to``, which also takes the JAX signature
        ``to(device=None, dtype=None, blocking=None)`` with paddle dtype
        names (``"bfloat16"``, ``"float16"``, ...). A dtype casts every
        floating parameter and buffer; parameters keep their identity
        (an optimizer's list still holds them)."""
        kwargs.pop("blocking", None)
        if kwargs.get("device", 0) is None:
            kwargs.pop("device")
        if isinstance(kwargs.get("dtype"), str):
            kwargs["dtype"] = to_torch(kwargs["dtype"])
        elif kwargs.get("dtype", 0) is None:
            kwargs.pop("dtype")
        args = tuple(to_torch(a) if isinstance(a, str) and _is_dtype_name(a)
                     else a for a in args)
        if not args and not kwargs:
            return self
        out = super().to(*args, **kwargs)
        dt = kwargs.get("dtype") or next(
            (a for a in args if isinstance(a, torch.dtype)), None)
        if dt is not None:
            for m in self.modules():
                if isinstance(m, Layer):
                    m._dtype = dt
        return out

    def state_dict(self, *args, **kwargs):
        """``torch.nn.Module.state_dict``; after ``amp.decorate(...,
        save_dtype=...)`` every floating entry is a copy in that dtype
        (the live tensors keep theirs)."""
        out = super().state_dict(*args, **kwargs)
        save = getattr(self, "_amp_save_dtype", None)
        # keep_vars asks for the live tensors (``_state_targets``)
        if save is not None and not kwargs.get("keep_vars", False):
            target = to_torch(save)
            for k, t in out.items():
                if t.is_floating_point() and t.dtype != target:
                    out[k] = t.detach().to(target)
        return out

    def set_state_dict(self, state_dict, use_structured_name=True):
        """Write ``{name: tensor or array}`` into the LIVE parameters and
        persistable buffers (never into ``state_dict()``'s copies), each
        cast to the tensor's dtype; returns the names it did not find."""
        missing = []
        with torch.no_grad():
            for name, t in _state_targets(self).items():
                if name not in state_dict:
                    missing.append(name)
                    continue
                t.copy_(_as_tensor(state_dict[name]))
        return missing

    load_dict = set_state_dict
    set_dict = set_state_dict


def _is_dtype_name(s: str) -> bool:
    try:
        to_torch(s)
    except (KeyError, TypeError):
        return False
    return True


def _as_tensor(v):
    """A tensor of ``v`` (a tensor or an array; numpy's bfloat16, which
    torch cannot take, arrives as its exact f32 values)."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    arr = np.array(v)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr)


def _state_targets(model: torch.nn.Module):
    """The live parameters and persistent buffers by state-dict name
    (not the copies a ``save_dtype`` state dict hands out)."""
    return torch.nn.Module.state_dict(model, keep_vars=True)


def load_numpy_state(model: torch.nn.Module, state, optimizer=None,
                     optimizer_state=None) -> None:
    """Copy ``{name: np.ndarray}`` (e.g. the JAX model's ``state_dict()``
    as numpy, parameters and buffers) into ``model``'s live tensors by
    name. Raises on a missing key, an extra key or a shape mismatch;
    values are cast to each tensor's dtype.

    With ``optimizer`` and ``optimizer_state`` (a JAX optimizer's
    ``state_dict()`` as numpy: ``"<param name>@<slot>"`` entries, masters
    ``@__master__`` included, and ``"step"``), that state goes into
    ``optimizer`` by ``Optimizer.set_state_dict``: the JAX parameter
    names are the port's (the same counters and rule)."""
    own = _state_targets(model)
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"load_numpy_state: missing {missing[:8]}, extra "
                       f"{extra[:8]} ({len(missing)} missing, {len(extra)} "
                       f"extra)")
    for name, t in own.items():
        arr = np.asarray(state[name])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"load_numpy_state: {name} has shape "
                             f"{tuple(arr.shape)}, the model wants "
                             f"{tuple(t.shape)}")
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(_as_tensor(state[name]))
    if optimizer is not None and optimizer_state is not None:
        optimizer.set_state_dict(optimizer_state)
