"""Automatic mixed precision: ``auto_cast`` and the cast rule the port's
functional ops consult, ``GradScaler`` and ``decorate``.

Port of ``paddle_tpu/amp/__init__.py``. The lists are the JAX package's
own ``WHITE_LIST`` and ``BLACK_LIST`` (copied), not ``torch.autocast``'s.
Each functional op passes its inputs through :func:`maybe_cast_inputs`
under the JAX op name:

- O1: a white-listed op (``linear``, ``matmul``, ...) casts its
  floating inputs to the low-precision type and a black-listed one
  (``layer_norm``, ``softmax_with_cross_entropy``, ...) casts bf16/f16
  inputs up to f32; every other op runs in the types it is given. So in
  BERT attention receives bf16 q/k/v (from bf16 projections) and the
  MLM head's ``fused_linear_cross_entropy`` receives f32 h and W (h
  comes out of the f32 layer norm).
- O2: every op that is not black-listed casts its floating inputs down
  (``amp/__init__.py:80-81``), the tensor arithmetic too: in the JAX
  package a ``Tensor``'s ``+`` is the ``add`` op. The port's models send
  that arithmetic through ``nn.functional.add`` and its siblings, which
  consult the rule under the JAX op names, so a residual ``f32 + bf16``
  runs in bf16 and BERT's loss ``mlm + nsp`` is bf16, as in JAX. There
  is no global ``TorchFunctionMode``: the plain versions, the optimizers
  and the batch-norm running update are not cast, as in JAX.

``GradScaler`` (``AmpScaler``) is JAX's dynamic loss scaling
(``:88-172``). ``unscale_`` divides each gradient by the scale as a
0-dim tensor of the gradient's type (a true division, which CUDA's
division by a Python scalar is not), then finds non-finite values with
one reduction over every gradient and one host read a step (JAX reads
one a parameter; the decision is the same). A step with a non-finite
gradient launches no update, clears the gradients and leaves the
optimizer's step count; ``update`` halves the scale after
``decr_every_n_nan_or_inf`` such steps, never below 1.

``decorate`` (``:175-231``) at O2 casts the models' floating parameters
and buffers to bf16/f16 and, with master weights (the default), turns
the optimizers to multi-precision: each low-precision parameter keeps
the f32 value it had BEFORE the cast as its master (slot
``__master__``), slots that already exist are upgraded and the rest are
seeded, so the first step updates the masters. ``save_dtype`` pins the
dtype of ``state_dict()``'s copies.
"""
from __future__ import annotations

import threading

import torch

from ..framework.dtype import to_torch
from ..regularizer import in_type

__all__ = ["WHITE_LIST", "BLACK_LIST", "auto_cast", "amp_guard",
           "amp_enabled", "amp_dtype", "maybe_cast_inputs", "GradScaler",
           "AmpScaler", "decorate"]

_state = threading.local()

# ops whose inputs are cast down under autocast (reference fp16_lists.py
# white_list)
WHITE_LIST = {"matmul", "conv1d", "conv2d", "conv3d", "linear", "bmm", "mv",
              "einsum"}
# numerically sensitive ops stay f32 (reference black_list)
BLACK_LIST = {"softmax_with_cross_entropy", "softmax", "log_softmax",
              "layer_norm", "reduce_mean", "reduce_sum", "exp", "log",
              "norm", "p_norm", "logsumexp"}

_LOW = (torch.bfloat16, torch.float16)
_LEVELS = ("O0", "O1", "O2")


def amp_enabled() -> bool:
    return getattr(_state, "level", "O0") != "O0"


def amp_dtype() -> torch.dtype:
    return getattr(_state, "dtype", torch.bfloat16)


class auto_cast:
    """``with amp.auto_cast(level="O1", dtype="bfloat16"):`` white-listed
    ops run in the low-precision type, black-listed ones in f32; at
    ``level="O2"`` every op but the black-listed ones runs in the
    low-precision type."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        if level not in _LEVELS:
            raise ValueError(f"auto_cast level {level!r}: one of {_LEVELS}")
        self.enable = enable
        self.level = level if enable else "O0"
        self.dtype = torch.bfloat16 if str(dtype) in ("bfloat16", "bf16") \
            else torch.float16
        self.white = set(custom_white_list or ()) | WHITE_LIST
        self.black = set(custom_black_list or ()) | BLACK_LIST

    def __enter__(self):
        self._prev = (getattr(_state, "level", "O0"),
                      getattr(_state, "dtype", torch.bfloat16),
                      getattr(_state, "white", WHITE_LIST),
                      getattr(_state, "black", BLACK_LIST))
        _state.level = self.level
        _state.dtype = self.dtype
        _state.white = self.white
        _state.black = self.black
        return self

    def __exit__(self, *exc):
        (_state.level, _state.dtype, _state.white,
         _state.black) = self._prev
        return False


amp_guard = auto_cast


def maybe_cast_inputs(op_name: str, tensors):
    """The inputs of op ``op_name`` as it runs under the active
    ``auto_cast`` (the JAX op bridge's rule); ``None`` and non-floating
    tensors pass unchanged."""
    level = getattr(_state, "level", "O0")
    if level == "O0":
        return list(tensors)
    black = getattr(_state, "black", BLACK_LIST)
    if op_name in getattr(_state, "white", WHITE_LIST) or \
            level == "O2" and op_name not in black:
        dt = amp_dtype()
        return [t.to(dt) if isinstance(t, torch.Tensor)
                and t.is_floating_point() else t for t in tensors]
    if op_name in black:
        return [t.to(torch.float32) if isinstance(t, torch.Tensor)
                and t.dtype in _LOW else t for t in tensors]
    return list(tensors)


# ---------------------------------------------------------------------------
# dynamic loss scaling
# ---------------------------------------------------------------------------
class GradScaler:
    """Dynamic loss scaling (the JAX ``GradScaler``, reference
    ``loss_scaler.py`` ``AmpScaler``)."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good = 0
        self._bad = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, loss):
        """``loss * scale`` in the loss's type (the scale rounded to it
        first, as JAX's weak-typed Python scalar is)."""
        if not self._enable:
            return loss
        return loss * in_type(self._scale, loss.dtype)

    def unscale_(self, optimizer):
        """Divide every gradient of ``optimizer``'s parameters by the
        scale, IN PLACE, and record whether any is non-finite."""
        if not self._enable or self._unscaled:
            return
        grads = [p.grad for p in optimizer._params() if p.grad is not None]
        flags = []
        for (dev, dt), gs in _groups(grads).items():
            s = torch.tensor(self._scale, dtype=dt, device=dev)
            for g in gs:
                g.div_(s)
            found = torch.zeros(1, dtype=torch.float32, device=dev)
            torch._amp_foreach_non_finite_check_and_unscale_(
                gs, found, torch.ones(1, dtype=torch.float32, device=dev))
            flags.append(found)
        self._found_inf = bool(flags) and bool(
            torch.cat([f.to(flags[0].device) for f in flags]).sum() > 0)
        self._unscaled = True

    def step(self, optimizer):
        """Unscale (unless done), then update, or on a non-finite
        gradient clear the gradients and update nothing."""
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if self._found_inf:
            optimizer.clear_grad()
        else:
            optimizer.step()
        self._unscaled = False

    def update(self):
        """The dynamic scale after a step: halved (at least 1) after
        ``decr_every_n_nan_or_inf`` skipped steps in a row, doubled after
        ``incr_every_n_steps`` good ones."""
        if not self._enable or not self._dynamic:
            return
        if self._found_inf:
            self._bad += 1
            self._good = 0
            if self._bad >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad = 0
        else:
            self._good += 1
            self._bad = 0
            if self._good >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good = 0
        self._found_inf = False

    def minimize(self, optimizer, scaled_loss):
        """``step`` then ``update`` (the backward of ``scaled_loss`` has
        run)."""
        self.step(optimizer)
        self.update()

    def is_enable(self):
        return self._enable

    def get_loss_scaling(self):
        return self._scale

    def state_dict(self):
        return {"scale": self._scale, "good": self._good, "bad": self._bad}

    def set_state_dict(self, state):
        self._scale = state["scale"]
        self._good = state["good"]
        self._bad = state["bad"]


AmpScaler = GradScaler


def _groups(tensors):
    """{(device, dtype): [tensor, ...]} in order."""
    out = {}
    for t in tensors:
        out.setdefault((t.device, t.dtype), []).append(t)
    return out


# ---------------------------------------------------------------------------
# O2: low-precision models with f32 master weights
# ---------------------------------------------------------------------------
def decorate(models=None, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate``: at ``level="O2"`` cast the models'
    floating parameters and buffers to ``dtype``; with ``master_weight``
    (None or True) each optimizer keeps an f32 master of every such
    parameter, snapshotted before the cast. ``save_dtype`` pins
    ``model.state_dict()``'s floating entries to that dtype. Returns
    ``models``, or ``(models, optimizers)`` when optimizers are given."""
    targets = [] if models is None else (
        list(models) if isinstance(models, (list, tuple)) else [models])
    opts = [] if optimizers is None else (
        list(optimizers) if isinstance(optimizers, (list, tuple))
        else [optimizers])
    if level == "O2":
        want_masters = master_weight is None or bool(master_weight)
        # the f32 values BEFORE the cast: a master carries the
        # full-precision bits, not a round trip through the low type
        masters = {}
        if want_masters:
            for m in targets:
                for p in m.parameters():
                    if p.is_floating_point():
                        masters[id(p)] = p.detach().to(
                            torch.float32, copy=True)
        for m in targets:
            m.to(dtype=to_torch(dtype))
        if want_masters:
            for o in opts:
                if not hasattr(o, "_multi_precision"):
                    continue
                o._multi_precision = True
                # upgrade the slots that exist (a warmed-up optimizer, a
                # restored checkpoint) and seed the rest, so the first
                # step after decorate takes the master path
                for p in o._parameter_list or []:
                    master = masters.get(id(p))
                    if master is None:
                        continue
                    slot = o._slots.get(id(p))
                    if slot is None:
                        slot = o._slots[id(p)] = o._init_slot(master)
                    slot.setdefault("__master__", master)
    if save_dtype is not None:
        for m in targets:
            m._amp_save_dtype = str(save_dtype)
    if optimizers is None:
        return models
    return models, optimizers
