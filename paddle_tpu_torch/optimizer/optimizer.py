"""Optimizers: ``Optimizer``, ``SGD``, ``Momentum``, ``Adam``, ``AdamW``
and ``Lamb``.

Port of the dygraph path of ``paddle_tpu/optimizer/optimizer.py``
(``apply_gradients_fn`` with ``_fused_or_rule``): the step t starts at
1; Adam is the dygraph form ``p - lr*(m/c1) / (sqrt(v/c2) + eps)`` with
``c1 = 1 - b1**t`` and ``c2 = 1 - b2**t`` in f32
(``ops/pallas/fused_optimizer.py:586-595``); AdamW then applies the
decoupled decay ``p2 - lr*wd*p`` with the OLD p (``optimizer.py:133``).
Momentum (``optimizer.py:286-304``) keeps a ``velocity`` that starts
at zero: ``v2 = mu*v + g``, ``p2 = p - lr*v2``, or with Nesterov
``p - lr*(g + mu*v2)``. A float ``weight_decay`` on ``Momentum`` or
plain ``Adam`` is the coupled L2 term ``g + wd*p``, as the JAX package's
``L2Decay`` folds it. SGD (``optimizer.py:281``) is ``p - lr*g``; its
coupled L2 term goes into the kernel, ``p - lr*(g + wd*p)``, rounded as
the JAX package's ``g + wd*p`` followed by the update.
Lamb (``optimizer.py:463-487``, the dygraph form of
``fused_try_rule``) keeps moment1/moment2 from zero and updates
``p - (lr*trust)*r`` with ``r = m_hat/(sqrt(v_hat) + eps) + wd*p`` and
``trust = |p|/|r|`` (1 where either norm is 0). Like the JAX rule, Lamb
decays EVERY parameter: ``exclude_from_weight_decay_fn`` is stored and
not applied.

``learning_rate`` is a float or an ``lr.LRScheduler``; ``get_lr()``
reads the scheduler's value, which the caller advances with
``scheduler.step()`` (``set_lr`` sets a float). The value reaches the
kernel as a host f32 argument each step (no host-to-device copy).

Regularization follows ``apply_gradients_fn`` (``:98-161``):
``grad_clip`` (an ``nn.clip`` object) clips the gradients first, then
each parameter's decay term is added to its gradient in the
parameter's own type: the parameter's ``regularizer``
(``ParamAttr.regularizer``) over the optimizer's, which is a
``regularizer`` object or a float ``weight_decay`` (``L2Decay`` of it).
An object on ``AdamW`` degrades to its ``coeff`` and decays decoupled
(``:44-48``). SGD folds a uniform L2 term into its kernel (its table
travels by value); any other regularizer is added before the launch.

``multi_precision`` (or ``amp.decorate(level="O2")``, which sets it)
gives every bf16/f16 parameter an f32 master in its slot dict
(``__master__``, ``_init_slot_mp`` ``:87-96``) with f32 state shaped
like it: the gradient, decayed in the parameter's type, is upcast, the
rule runs on the master, and the parameter receives the master's cast
(``:115-128``); AdamW's decoupled decay uses the old master. A
low-precision parameter without a master (``multi_precision=False``,
``decorate(master_weight=False)``) keeps state of its own type: on the
CPU the plain versions update it; on the card ``step()`` raises, since
the card's kernels take f32 parameters or the master forms and the
2-byte forms without a master are not ported yet.

The whole update is one ``ops.cuda.fused_optimizer`` call
(``fused_sgd_``, ``fused_momentum_``, ``fused_adam_`` or
``fused_lamb_``) over every parameter that has a gradient, one for the
f32 parameters and one for each type of master-weight parameters: one
kernel launch each on CUDA (Lamb: two, phase 1 with its per-tensor
norms, then the apply), the plain version on the CPU. Parameters and
optimizer state are updated IN PLACE (the JAX update is functional).

``state_dict()`` has the JAX keys: ``"<param name>@<slot>"`` (masters
as ``@__master__``), ``"step"``, and ``"LR_Scheduler"`` for a
scheduler; ``set_state_dict`` gives every parameter of that name its
slots. Both raise when two parameters of the list share a name (the
layers ``TransformerEncoder`` copies keep their names): the JAX
optimizer's keys then hold one parameter's slots for all of them, and
loading them would give every copy that one parameter's master.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..nn.clip import ClipGradBase
from ..ops.cuda.fused_optimizer import (fused_adam_, fused_lamb_,
                                        fused_momentum_, fused_sgd_)
from ..regularizer import L2Decay
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Lamb"]

_LOW = (torch.bfloat16, torch.float16)
MASTER = "__master__"


class Optimizer:
    DECOUPLED_WD = False
    SLOTS = ()          # per-parameter state, zeros like the parameter

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if grad_clip is not None and not isinstance(grad_clip,
                                                    ClipGradBase):
            raise TypeError(f"grad_clip must be an nn.clip object "
                            f"(ClipGradByGlobalNorm, ...), got "
                            f"{type(grad_clip).__name__}")
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"lr.LRScheduler, got "
                            f"{type(learning_rate).__name__}")
        self._learning_rate = learning_rate \
            if isinstance(learning_rate, LRScheduler) \
            else float(learning_rate)
        self._grad_clip = grad_clip
        self._parameter_list = (list(parameters) if parameters is not None
                                else None)
        if weight_decay is None or isinstance(weight_decay, (int, float)):
            self._l2_coeff = float(weight_decay or 0.0)
            self._wd = None
        elif self.DECOUPLED_WD:
            # an object degrades to its coefficient, applied decoupled
            self._l2_coeff = float(getattr(weight_decay, "coeff", 0.0))
            self._wd = None
        else:
            # a coupled regularizer (L1Decay/L2Decay): folded into grads
            self._l2_coeff = 0.0
            self._wd = weight_decay
        self._step_count = 0
        self._slots: Dict[int, dict] = {}
        self._kernel_cache: dict = {}
        self._multi_precision = bool(multi_precision)

    def _params(self):
        if self._parameter_list is None:
            raise ValueError("Optimizer constructed without parameters; "
                             "pass parameters=model.parameters()")
        return [p for p in self._parameter_list if p.requires_grad]

    # -- lr ------------------------------------------------------------------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return self._learning_rate

    def set_lr(self, value) -> None:
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("set_lr cannot override an LRScheduler")
        self._learning_rate = float(value)

    # -- eager API -----------------------------------------------------------
    def clear_grad(self, set_to_zero=False) -> None:
        """Drop the gradients (the next backward allocates fresh ones)."""
        for p in self._params():
            p.grad = None

    clear_gradients = clear_grad

    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter that has a gradient."""
        live = [p for p in self._params() if p.grad is not None]
        if live:
            t = self._step_count + 1
            groups = self._groups(live)
            for (dtype, master), ps in groups.items():
                if dtype in _LOW and not master and ps[0].is_cuda:
                    raise NotImplementedError(
                        f"{dtype} parameters without f32 masters have no "
                        f"kernel on the card yet; use multi_precision=True "
                        f"(amp.decorate's master_weight=True)")
            for key, ps in groups.items():
                masters = [self._slot(p)[MASTER] for p in ps] \
                    if key[1] else None
                self._apply(ps, [p.grad for p in ps], t, masters,
                            self._kernel_cache.setdefault(key, {}))
        self._step_count += 1

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Backward of ``loss`` when no parameter has a gradient yet, then
        ``step()``."""
        if loss is not None and loss.requires_grad and all(
                p.grad is None for p in self._params()):
            loss.backward()
        self.step()
        return None, None

    def _groups(self, params):
        """{(dtype, has master): [param, ...]}: one fused call each."""
        out = {}
        for p in params:
            master = MASTER in self._slot(p)
            out.setdefault((p.dtype, master), []).append(p)
        return out

    # -- state ---------------------------------------------------------------
    def _init_slot(self, like):
        return {k: torch.zeros_like(like) for k in self.SLOTS}

    def _init_slot_mp(self, p):
        """The slots of ``p``, plus its f32 master (``p`` upcast) when
        multi-precision is on and ``p`` is bf16/f16; the state is then
        shaped and typed like the master."""
        if self._multi_precision and p.dtype in _LOW:
            master = p.detach().to(torch.float32, copy=True)
            slots = self._init_slot(master)
            slots[MASTER] = master
            return slots
        return self._init_slot(p.detach())

    def _slot(self, p):
        s = self._slots.get(id(p))
        if s is None:
            s = self._slots[id(p)] = self._init_slot_mp(p)
        return s

    def _unique_names(self):
        """Raise when two parameters of the list share a name (their
        ``<name>@<slot>`` keys would collide)."""
        seen = set()
        for p in self._parameter_list or []:
            if p.name in seen:
                raise ValueError(
                    f"parameters share the name {p.name!r}: their "
                    f"optimizer state cannot be keyed by name; give each "
                    f"copied layer's parameters names of their own")
            seen.add(p.name)

    def state_dict(self):
        """``{"step": n, "<param name>@<slot>": tensor, ...}`` (copies),
        ``"LR_Scheduler"`` for a scheduler."""
        self._unique_names()
        out = {"step": self._step_count}
        for p in self._parameter_list or []:
            for k, v in (self._slots.get(id(p)) or {}).items():
                out[f"{p.name}@{k}"] = v.detach().clone()
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state):
        """The step and every parameter's slots from a ``state_dict()``
        (tensors or arrays, this package's or the JAX package's): each
        parameter whose name prefixes a key takes those slots, on its
        device; a master and a master's state are f32, other state the
        parameter's type."""
        from ..nn.layer import _as_tensor

        self._unique_names()
        self._step_count = int(state.get("step", 0))
        for p in self._parameter_list or []:
            slot = {key.split("@", 1)[1]: v for key, v in state.items()
                    if key.startswith(f"{p.name}@")}
            if not slot:
                continue
            dt = torch.float32 if MASTER in slot else p.dtype
            self._slots[id(p)] = {
                k: _as_tensor(v).to(device=p.device, dtype=dt, copy=True)
                for k, v in slot.items()}
        if "LR_Scheduler" in state and isinstance(self._learning_rate,
                                                   LRScheduler):
            self._learning_rate.set_state_dict(state["LR_Scheduler"])

    # -- regularization ------------------------------------------------------
    def _default_regularizer(self):
        if self._wd is not None:
            return self._wd
        if self._l2_coeff and not self.DECOUPLED_WD:
            return L2Decay(self._l2_coeff)
        return None

    def _regularizers(self, params):
        """Each parameter's regularizer: its own over the optimizer's
        (the reference's ``append_regularization_ops`` precedence)."""
        default = self._default_regularizer()
        return [getattr(p, "regularizer", None) or default for p in params]

    def _clipped(self, grads):
        """The gradients clipped by ``grad_clip`` (as they are without
        one)."""
        if self._grad_clip is not None:
            return self._grad_clip.apply_pytree(grads)
        return grads

    def _grads(self, params, grads, regs=None):
        """The gradients the rule sees: clipped by ``grad_clip``, then
        ``g + reg.grad_term(p)`` in the parameter's type."""
        grads = self._clipped(grads)
        regs = self._regularizers(params) if regs is None else regs
        return [g if r is None else r(g, p)
                for g, p, r in zip(grads, params, regs)]

    def _apply(self, params, grads, t, masters, cache):
        raise NotImplementedError


def _uniform_l2(regs):
    """The coefficient when every regularizer is None (0.0) or all are
    ``L2Decay`` of one coefficient; None otherwise."""
    if all(r is None for r in regs):
        return 0.0
    if all(type(r) is L2Decay for r in regs) and \
            len({r.coeff for r in regs}) == 1:
        return regs[0].coeff
    return None


class SGD(Optimizer):
    def _apply(self, params, grads, t, masters, cache):
        # a uniform L2 term is the kernel's: no g + wd*p tensors here;
        # on the card, what the last step's launches covered is kept
        regs = self._regularizers(params)
        wd = _uniform_l2(regs)
        if wd is None:
            grads, wd = self._grads(params, grads, regs), 0.0
        else:
            grads = self._clipped(grads)
        self._last_launch = fused_sgd_(
            [p.detach() for p in params], grads, lr=self.get_lr(),
            weight_decay=wd, masters=masters)


class Momentum(Optimizer):
    SLOTS = ("velocity",)

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._nesterov = bool(use_nesterov)

    def _apply(self, params, grads, t, masters, cache):
        slots = [self._slot(p) for p in params]
        fused_momentum_([p.detach() for p in params],
                        self._grads(params, grads),
                        [s["velocity"] for s in slots], lr=self.get_lr(),
                        momentum=self._momentum, nesterov=self._nesterov,
                        cache=cache, masters=masters)


class Adam(Optimizer):
    SLOTS = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _apply(self, params, grads, t, masters, cache):
        slots = [self._slot(p) for p in params]
        fused_adam_([p.detach() for p in params],
                    self._grads(params, grads),
                    [s["moment1"] for s in slots],
                    [s["moment2"] for s in slots],
                    lr=self.get_lr(), beta1=self._beta1, beta2=self._beta2,
                    eps=self._eps, step=t,
                    weight_decay=self._l2_coeff if self.DECOUPLED_WD else 0.0,
                    cache=cache, masters=masters)


class AdamW(Adam):
    DECOUPLED_WD = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 grad_clip=None, lr_ratio=None, apply_decay_param_fun=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, name=name,
                         multi_precision=multi_precision)


class Lamb(Optimizer):
    SLOTS = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._lamb_wd = lamb_weight_decay
        # stored and not applied, as in the JAX rule (optimizer.py:471,
        # :483 decays every parameter)
        self._exclude_fn = exclude_from_weight_decay_fn
        # the trust-ratio numerator r of each parameter: f32 scratch the
        # kernels overwrite every step (not optimizer state)
        self._trust_r: Dict[int, torch.Tensor] = {}

    def _scratch(self, p):
        r = self._trust_r.get(id(p))
        if r is None:
            like = self._slot(p).get(MASTER, p)
            r = self._trust_r[id(p)] = torch.empty_like(like)
        return r

    def _apply(self, params, grads, t, masters, cache):
        slots = [self._slot(p) for p in params]
        fused_lamb_([p.detach() for p in params], self._grads(params, grads),
                    [s["moment1"] for s in slots],
                    [s["moment2"] for s in slots],
                    [self._scratch(p) for p in params], lr=self.get_lr(),
                    beta1=self._beta1, beta2=self._beta2, eps=self._eps,
                    weight_decay=self._lamb_wd, step=t, cache=cache,
                    masters=masters)
