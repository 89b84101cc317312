"""``Tensor``: the user-facing value type, a ``torch.Tensor`` subclass.

Port of ``paddle_tpu/framework/tensor.py``. The JAX ``Tensor`` wraps an
immutable array; the port's IS a ``torch.Tensor`` (its storage, device
and autograd graph are PyTorch's), so it goes wherever a tensor goes,
and ``nn.Parameter`` is one too (``nn.layer.Parameter``), as the JAX
``Parameter`` subclasses the JAX ``Tensor``.

Two sets of semantics meet on it. Paddle's must hold in a user's code:
``t.size`` is an int, ``t.transpose(perm)``, ``t.split(n)`` makes ``n``
pieces, ``t.max(axis)`` gives the values only, ``t.numpy()`` works on a
tensor that needs a gradient, ``t.stop_gradient``, ``t.astype``, ...
PyTorch's must hold in the port's own code and in PyTorch's, whatever a
user passed in. A per-thread depth count tells the two apart:

- the port's public entries (``Layer.__call__`` of the port's layers
  and their public methods, ``forward`` included, so that a user's
  subclass that inherits a port layer's ``forward`` or calls
  ``super().forward`` still runs the port's code as the port's;
  ``TrainStep.__call__``, the optimizers' methods, ``nn.functional``'s
  functions, the op library, ``autograd.grad``, ``Tensor.backward``)
  raise the depth while they run (:func:`entry`, the one decorator);
- a method of the method table, a dunder or ``__getitem__`` called
  while the depth is above 0 is ``torch.Tensor``'s own; at depth 0 it
  is paddle's, and its result is a ``Tensor``;
- an entry called at depth 0 returns its tensors as ``Tensor``s unless
  the only tensors it was given were plain ones (code that passes plain
  torch tensors gets plain tensors back, as before; a creation op
  gives ``Tensor``s); below the outermost entry nothing is wrapped, so
  a model's hundreds of nested calls cost one depth check each;
- user code that the port calls back (a user-defined layer inside a
  port ``Sequential``, a ``PyLayer``'s forward and backward, a
  ``TrainStep``'s loss function, ``recompute``'s function) runs at
  depth 0 in a :class:`user_scope`;
- threads that Python did not start (PyTorch's autograd device
  threads, which run the port's backward functions) start at depth 1.

``__torch_function__`` is disabled, as for ``nn.Parameter``: a torch
function or a torch method given a ``Tensor`` returns a plain tensor
and costs nothing extra. ``size`` is an ``int`` that can also be
called as ``torch.Tensor.size`` (``t.size(0)``), so PyTorch's own code
keeps working on a user's tensor.

``dtype`` is the torch dtype; the port's top-level dtype objects are
torch's (``paddle_tpu_torch.float32 is torch.float32``). ``numpy()`` of
a bfloat16 tensor gives its exact float32 values (numpy has no
bfloat16); ``grad`` is a ``Tensor`` in a user's code.

Dtypes of :func:`to_tensor` follow the JAX package wherever JAX chose
them (a Python float takes the default dtype, float32) and keep the
requested type where only JAX's 32-bit mode narrowed it (an int64 or
float64 array, a Python int: int64, float64).
"""
from __future__ import annotations

import functools
import inspect
import itertools
import threading

import numpy as np
import torch

from .._device import resolve_device
from . import dtype as dtype_mod

__all__ = ["Tensor", "to_tensor", "is_tensor", "unwrap", "wrap", "entry",
           "entry_methods", "EntryClass", "user_entry", "user_callback",
           "user_scope"]

_tls = threading.local()
_COUNT = itertools.count(1)
_DUMMY = getattr(threading, "_DummyThread", ())


def _depth() -> int:
    d = getattr(_tls, "depth", None)
    if d is None:
        d = 1 if isinstance(threading.current_thread(), _DUMMY) else 0
        _tls.depth = d
    return d


class user_scope:
    """Run a block as a user's code (depth 0), inside the port."""

    def __enter__(self):
        self._prev = _depth()
        _tls.depth = 0
        return self

    def __exit__(self, *exc):
        _tls.depth = self._prev
        return False


def _wants_tensor(args, kwargs) -> bool:
    """The wrapping rule of every entry: its tensors come back as
    ``Tensor``s unless the only tensors it was given were plain ones
    (a ``Tensor`` among its arguments, one level into lists and
    tuples, or no tensor at all, as a creation op takes)."""
    plain = False
    for a in itertools.chain(args, kwargs.values()):
        for x in a if isinstance(a, (list, tuple)) else (a,):
            if isinstance(x, Tensor):
                return True
            plain = plain or isinstance(x, torch.Tensor)
    return not plain


def wrap(out):
    """``out`` with every plain torch tensor in it (through tuples,
    lists and dicts) made a :class:`Tensor` (same storage and autograd
    graph); other values and tensor subclasses pass unchanged."""
    if type(out) is torch.Tensor:
        return out.as_subclass(Tensor)
    if isinstance(out, tuple):
        items = [wrap(o) for o in out]
        if hasattr(out, "_fields"):                 # a namedtuple
            return type(out)(*items)
        return tuple(items)
    if isinstance(out, list):
        return [wrap(o) for o in out]
    if isinstance(out, dict):
        return {k: wrap(v) for k, v in out.items()}
    return out


def unwrap(x):
    """``Tensor`` -> plain ``torch.Tensor`` (same storage, still on the
    autograd graph); anything else unchanged."""
    if isinstance(x, Tensor):
        return x.as_subclass(torch.Tensor)
    return x


def entry(fn, outer=None):
    """Mark ``fn`` as one of the port's public entries: called from a
    user's code it runs ``outer`` (default ``fn``; the op library's
    AMP cast and NaN scan, ``framework.op``) as the port's code and
    returns its tensors by :func:`_wants_tensor`'s rule; called from the
    port's own code it is the bare ``fn``."""
    run = outer or fn

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _depth():
            return fn(*args, **kwargs)
        _tls.depth = 1
        try:
            out = run(*args, **kwargs)
        finally:
            _tls.depth = 0
        return wrap(out) if _wants_tensor(args, kwargs) else out

    wrapper.__port_entry__ = True
    return wrapper


def entry_methods(cls, names=None):
    """Make the public methods of ``cls`` (its own, or those in
    ``names``) :func:`entry` points; returns ``cls``."""
    for name, fn in list(vars(cls).items()):
        if names is None and name.startswith("_") or \
                names is not None and name not in names:
            continue
        if inspect.isfunction(fn) and not getattr(fn, "__port_entry__",
                                                  False):
            setattr(cls, name, entry(fn))
    return cls


class EntryClass:
    """A base whose subclasses in the port's own modules have their
    public methods made :func:`entry` points (a user's subclass keeps
    its methods as written)."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if is_port_class(cls):
            entry_methods(cls)


def is_port_class(cls) -> bool:
    return cls.__module__.startswith("paddle_tpu_torch.")


def user_entry(fn):
    """Run ``fn`` (a user's code that the port calls) at depth 0, its
    tensor arguments as ``Tensor``s; from port code its results come
    back as given."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _depth():
            return fn(*args, **kwargs)
        with user_scope():
            return fn(*wrap(args), **wrap(kwargs))

    return wrapper


def user_callback(fn):
    """``fn``, a callable handed to the port (a ``TrainStep``'s loss
    function, ``recompute``'s function): handed over from a user's code
    it runs as a user's code wherever the port calls it (its arguments
    as they come); from the port's own code it is ``fn``."""
    if fn is None or _depth():
        return fn

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with user_scope():
            return fn(*args, **kwargs)

    return wrapper


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------
def _as_plain(value, dtype=None, device=None) -> torch.Tensor:
    """A new plain tensor (its own storage) of ``value`` (a tensor, a
    numpy array, a Python scalar or nested list) by the dtype rule of
    the module docstring."""
    tdt = dtype_mod.to_torch(dtype) if dtype is not None else None
    if isinstance(value, torch.Tensor):
        t = torch.Tensor.detach(value)
        dev = device if device is not None else t.device
        return t.to(device=dev, dtype=tdt or t.dtype, copy=True)
    if isinstance(value, np.ndarray) or isinstance(value, np.generic):
        arr = np.asarray(value)
    else:
        arr = np.asarray(value)
        if tdt is None and arr.dtype == np.float64:
            tdt = dtype_mod.default_torch_dtype()
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
        tdt = tdt or torch.bfloat16
    if arr.dtype == object:
        raise TypeError(f"to_tensor cannot convert {type(value).__name__} "
                        f"of mixed objects")
    t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    dev = device if device is not None else resolve_device(None)
    return t.to(device=dev, dtype=tdt or t.dtype)


class _Size(int):
    """``Tensor.size``: paddle's element count, an ``int``; called, it
    is ``torch.Tensor.size`` (``t.size()``, ``t.size(0)``)."""

    def __call__(self, dim=None):
        if dim is None:
            return torch.Tensor.size(self._t)
        return torch.Tensor.size(self._t, dim)


_GRAD = torch.Tensor.grad


def _dual(name, paddle_fn):
    """A method that is paddle's (``paddle_fn``) in a user's code and
    ``torch.Tensor``'s own in the port's."""
    torch_fn = getattr(torch.Tensor, name, None)
    if torch_fn is None:
        return paddle_fn

    def method(self, *args, **kwargs):
        if _depth():
            return torch_fn(self, *args, **kwargs)
        return paddle_fn(self, *args, **kwargs)

    method.__name__ = name
    method.__doc__ = paddle_fn.__doc__
    return method


class Tensor(torch.Tensor):
    """``Tensor(value, dtype=None, place=None, stop_gradient=True,
    name=None, persistable=False)``: a copy of ``value`` on ``place``
    (None: the default device, ``set_device``; a tensor stays on its
    own)."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __new__(cls, value, dtype=None, place=None, stop_gradient=True,
                name=None, persistable=False):
        from .place import place_device

        dev = place_device(place) if place is not None else None
        t = _as_plain(value, dtype, dev)
        grad = (not stop_gradient) and (t.is_floating_point()
                                        or t.is_complex())
        return torch.Tensor._make_subclass(cls, t, grad)

    def __init__(self, value, dtype=None, place=None, stop_gradient=True,
                 name=None, persistable=False):
        if name is not None:
            self.name = name
        if persistable:
            self.persistable = True

    __hash__ = torch.Tensor.__hash__

    # -- attributes ---------------------------------------------------------
    @property
    def name(self):
        n = self.__dict__.get("_pname")
        if n is None:
            n = self.__dict__["_pname"] = f"tensor_{next(_COUNT)}"
        return n

    @name.setter
    def name(self, value):
        self.__dict__["_pname"] = value

    @property
    def persistable(self):
        return self.__dict__.get("_persistable", False)

    @persistable.setter
    def persistable(self, value):
        self.__dict__["_persistable"] = bool(value)

    @property
    def stop_gradient(self):
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value):
        if value:
            if self.is_leaf:
                self.requires_grad_(False)
            else:
                self.detach_()
        else:
            self.requires_grad_(True)

    @property
    def trainable(self):
        return self.requires_grad

    @trainable.setter
    def trainable(self, value):
        self.stop_gradient = not value

    @property
    def grad(self):
        """The accumulated gradient: a ``Tensor`` in a user's code (so
        ``x.grad.numpy()`` works on the card), the plain tensor inside
        the port."""
        g = _GRAD.__get__(self)
        if g is None or _depth() or type(g) is not torch.Tensor:
            return g
        return g.as_subclass(Tensor)

    @grad.setter
    def grad(self, value):
        _GRAD.__set__(self, value)

    @grad.deleter
    def grad(self):
        _GRAD.__delete__(self)

    @property
    def size(self):
        s = _Size(torch.Tensor.numel(self))
        s._t = self
        return s

    @property
    def place(self):
        from .place import place_of

        return place_of(self.device)

    @property
    def value(self):
        """The plain ``torch.Tensor`` (the JAX ``Tensor.value``)."""
        return self.as_subclass(torch.Tensor)

    def __repr__(self, *, tensor_contents=None):
        grad = "" if self.stop_gradient else ", stop_gradient=False"
        return (f"Tensor(shape={list(self.shape)}, dtype="
                f"{dtype_mod.dtype_name(self.dtype)}, place={self.place}"
                f"{grad},\n       {self.numpy()})")

    # -- conversion ---------------------------------------------------------
    def _numpy(self):
        t = torch.Tensor.detach(self).cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    def _astype(self, dtype):
        from .. import ops

        return ops.cast(self, dtype)

    def __float__(self):
        return float(torch.Tensor.detach(self).item())

    def __int__(self):
        return int(torch.Tensor.detach(self).item())

    def astype(self, dtype):
        """A copy in ``dtype`` (differentiable)."""
        return self._astype(dtype)

    def cast(self, dtype):
        return self._astype(dtype)

    def _to(self, *args, **kwargs):
        from .place import Place

        args = tuple(a.torch_device() if isinstance(a, Place)
                     else dtype_mod.to_torch(a)
                     if isinstance(a, str) and a in _DTYPE_NAMES else a
                     for a in args)
        return wrap(torch.Tensor.to(self, *args, **kwargs))

    def _cpu(self):
        return wrap(torch.Tensor.cpu(self))

    def _cuda(self, *args, **kwargs):
        return wrap(torch.Tensor.cuda(self, *args, **kwargs))

    # -- autograd -----------------------------------------------------------
    def _backward(self, grad_tensor=None, retain_graph=False):
        from .tape import backward

        backward(self, grad_tensor, retain_graph)

    def _detach(self):
        return torch.Tensor.detach(self).as_subclass(Tensor)

    def _clone(self):
        from .. import ops

        return ops.assign(self)

    def clear_gradient(self, set_to_zero=False):
        self.grad = None

    def clear_grad(self, set_to_zero=False):
        self.grad = None

    def gradient(self):
        """The gradient as a numpy array, or None."""
        g = self.grad
        return None if g is None else Tensor._numpy(g)

    # -- in-place -----------------------------------------------------------
    def set_value(self, value):
        """Overwrite the values (same shape; cast to this dtype)."""
        v = value if isinstance(value, torch.Tensor) else \
            _as_plain(value, None, self.device)
        if tuple(v.shape) != tuple(self.shape):
            raise ValueError(f"set_value shape mismatch {tuple(v.shape)} "
                             f"vs {tuple(self.shape)}")
        with torch.no_grad():
            torch.Tensor.copy_(self, v.to(self.dtype))
        return self

    def scale_(self, s):
        with torch.no_grad():
            torch.Tensor.mul_(self, s)
        return self

    # -- indexing -----------------------------------------------------------
    def _getitem(self, idx):
        from .. import ops

        return ops.getitem(self, idx)

    def _setitem(self, idx, value):
        if isinstance(idx, Tensor):
            idx = unwrap(idx)
        if self.is_leaf and self.requires_grad:
            with torch.no_grad():
                torch.Tensor.__setitem__(self, idx, value)
        else:
            torch.Tensor.__setitem__(self, idx, value)

    def _iter(self):
        for i in range(len(self)):
            yield self[i]


_DTYPE_NAMES = frozenset(dtype_mod._TORCH) | {"fp16", "fp32", "fp64",
                                               "bf16"}

for _name, _fn in (("numpy", Tensor._numpy), ("to", Tensor._to),
                   ("cpu", Tensor._cpu), ("cuda", Tensor._cuda),
                   ("backward", Tensor._backward),
                   ("detach", Tensor._detach), ("clone", Tensor._clone),
                   ("__getitem__", Tensor._getitem),
                   ("__setitem__", Tensor._setitem),
                   ("__iter__", Tensor._iter)):
    setattr(Tensor, _name, _dual(_name, _fn))


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """``paddle.to_tensor``: a new :class:`Tensor` of ``data`` (see the
    module docstring for its dtype)."""
    return Tensor(data, dtype=dtype, place=place,
                  stop_gradient=stop_gradient)


def is_tensor(x):
    return isinstance(x, Tensor)
