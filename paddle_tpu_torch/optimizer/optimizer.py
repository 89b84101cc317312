"""Optimizers: ``Optimizer``, ``SGD``, ``Momentum``, ``Adam``, ``AdamW``,
``Lamb``, and the eight rules without a kernel (below).

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
``decorate(master_weight=False)``) keeps state of its own type, and the
rule runs in that type, each operation rounded to it, as JAX's XLA route
runs it (``:131-134``): the kernels' 2-byte forms on the card, their
plain versions on the CPU.

The whole update is one ``ops.cuda.fused_optimizer`` call
(``fused_sgd_``, ``fused_momentum_``, ``fused_adam_`` or
``fused_lamb_``) over every parameter that has a gradient, one for the
f32 parameters, one for each type of master-weight parameters and one
for each 2-byte type without masters: one kernel launch each on CUDA
(Lamb: two, phase 1 with its per-tensor norms, then the apply), the
plain version on the CPU. Parameters and
optimizer state are updated IN PLACE (the JAX update is functional).

``Adamax``, ``Adagrad``, ``DecayedAdagrad``, ``Adadelta``, ``RMSProp``,
``Ftrl``, ``LarsMomentum`` and ``Dpsgd`` (``optimizer.py:340-535``)
have no TPU kernel: JAX runs their ``rule`` in XLA (its fused gate knows
only the four above, ``fused_optimizer.py:541-547``). Here each is that
rule in PyTorch tensor operations on the parameter's device, one
parameter at a time, in the parameter's type (a Python scalar meeting a
tensor rounded to its type first, a divisor a 0-dim tensor of its type)
or on its f32 master, with the same regularizers, clip, slots and
initial values; one ``optimizer_rule.<class name>`` count per parameter
updated (``ops.cuda.counters``), so a run shows which route it took.
``Dpsgd``'s noise is drawn from a ``torch.Generator`` on the
parameter's device seeded with ``framework.random.fold_in(seed, t)``,
anew for every parameter, as JAX draws every parameter's noise from
``fold_in(key, t)``; the bits differ from threefry's.

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

import numpy as np
import torch

from ..framework.random import fold_in
from ..framework.tensor import EntryClass, entry_methods
from ..nn.clip import ClipGradBase
from ..ops.cuda import counters
from ..ops.cuda.fused_optimizer import (fused_adam_, fused_lamb_,
                                        fused_momentum_, fused_sgd_)
from ..regularizer import L2Decay, in_type
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Lamb",
           "Adamax", "Adagrad", "DecayedAdagrad", "Adadelta", "RMSProp",
           "Ftrl", "LarsMomentum", "Dpsgd", "RuleOptimizer"]

_LOW = (torch.bfloat16, torch.float16)
MASTER = "__master__"


class Optimizer(EntryClass):
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


entry_methods(Optimizer)


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


# ---------------------------------------------------------------------------
# The rules JAX runs in XLA only: tensor operations, no kernel
# ---------------------------------------------------------------------------
def _k(x, like) -> float:
    """A Python scalar as JAX's weak type meets ``like``: rounded to its
    type (PyTorch then computes in f32 and rounds once)."""
    return in_type(x, like.dtype)


def _div(a, b):
    """``a / b`` for a Python scalar ``b``, as a division by a 0-dim
    tensor of ``a``'s type (CUDA would multiply by the reciprocal of a
    Python scalar)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _host(op, a, b, dtype) -> float:
    """``op(a, b)`` of two Python scalars computed in ``dtype`` on the
    host, each rounded to it first, the result rounded to it: a
    scalar-by-scalar step of a rule (JAX's ``lr / c`` over 0-dim arrays
    of the type)."""
    x = torch.tensor(float(a), dtype=dtype)
    y = torch.tensor(float(b), dtype=dtype)
    return float(op(x, y).item())


def _norm(x):
    """``sqrt(sum(square(x)))`` in ``x``'s type (the squares rounded to
    it, the sum accumulated in f32 and rounded to it)."""
    return torch.sqrt(torch.sum(x * x))


class RuleOptimizer(Optimizer):
    """An optimizer whose update is its ``rule(g, p, slots, lr, t)`` in
    tensor operations, returning ``(p2, new slots)``, run one parameter
    at a time (the JAX package's ``rule``): on the parameter in its own
    type, or, for a parameter with an f32 master, on the master with the
    gradient upcast, the parameter then set to the master's cast.
    Gradients are clipped and regularized as the kernel rules' are;
    counted ``optimizer_rule.<class name>`` once a parameter."""
    INIT = 0.0        # the slots' initial value

    def _init_slot(self, like):
        return {k: torch.full_like(like, self.INIT) for k in self.SLOTS}

    def rule(self, g, p, slots, lr, t):
        raise NotImplementedError

    def _apply(self, params, grads, t, masters, cache):
        grads = self._grads(params, grads)
        lr = self.get_lr()
        for i, (p, g) in enumerate(zip(params, grads)):
            slots = self._slot(p)
            state = {k: v for k, v in slots.items() if k != MASTER}
            if masters is not None:
                w = masters[i]
                w2, new = self.rule(g.to(w.dtype), w, state, lr, t)
                w.copy_(w2)
                p.copy_(w2)
            else:
                p2, new = self.rule(g, p.detach(), state, lr, t)
                p.copy_(p2)
            for k, v in new.items():
                slots[k].copy_(v)
        counters.bump("optimizer_rule." + type(self).__name__, len(params))


class Adamax(RuleOptimizer):
    SLOTS = ("moment", "inf_norm")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def rule(self, g, p, slots, lr, t):
        b1, b2 = self._beta1, self._beta2
        m = _k(b1, p) * slots["moment"] + _k(1 - b1, p) * g
        u = torch.maximum(_k(b2, p) * slots["inf_norm"], torch.abs(g))
        c = np.float32(1) - np.power(np.float32(b1), np.float32(t),
                                     dtype=np.float32)
        lr_t = _host(torch.div, lr, c, p.dtype)
        p2 = p - (lr_t * m) / (u + _k(self._eps, p))
        return p2, {"moment": m, "inf_norm": u}


class Adagrad(RuleOptimizer):
    SLOTS = ("moment",)

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._eps = epsilon
        self.INIT = initial_accumulator_value

    def rule(self, g, p, slots, lr, t):
        acc = slots["moment"] + g * g
        p2 = p - (_k(lr, p) * g) / (torch.sqrt(acc) + _k(self._eps, p))
        return p2, {"moment": acc}


class DecayedAdagrad(RuleOptimizer):
    SLOTS = ("moment",)

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._decay, self._eps = decay, epsilon

    def rule(self, g, p, slots, lr, t):
        d = self._decay
        acc = _k(d, p) * slots["moment"] + _k(1 - d, p) * (g * g)
        p2 = p - (_k(lr, p) * g) / (torch.sqrt(acc) + _k(self._eps, p))
        return p2, {"moment": acc}


class Adadelta(RuleOptimizer):
    SLOTS = ("avg_squared_grad", "avg_squared_update")

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._eps, self._rho = epsilon, rho

    def rule(self, g, p, slots, lr, t):
        rho, eps = _k(self._rho, p), _k(self._eps, p)
        omr = _k(1 - self._rho, p)
        eg = rho * slots["avg_squared_grad"] + omr * (g * g)
        update = -torch.sqrt((slots["avg_squared_update"] + eps)
                             / (eg + eps)) * g
        eu = rho * slots["avg_squared_update"] + omr * (update * update)
        return p + _k(lr, p) * update, {"avg_squared_grad": eg,
                                        "avg_squared_update": eu}


class RMSProp(RuleOptimizer):
    SLOTS = ("mean_square", "mean_grad", "momentum")

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def rule(self, g, p, slots, lr, t):
        rho, omr = _k(self._rho, p), _k(1 - self._rho, p)
        ms = rho * slots["mean_square"] + omr * (g * g)
        mg = rho * slots["mean_grad"] + omr * g if self._centered \
            else slots["mean_grad"]
        denom = ms - mg * mg if self._centered else ms
        mom = _k(self._momentum, p) * slots["momentum"] + \
            (_k(lr, p) * g) / torch.sqrt(denom + _k(self._eps, p))
        return p - mom, {"mean_square": ms, "mean_grad": mg,
                         "momentum": mom}


class Ftrl(RuleOptimizer):
    SLOTS = ("squared", "linear")

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def rule(self, g, p, slots, lr, t):
        n, z = slots["squared"], slots["linear"]
        n2 = n + g * g
        lp, lr_t = _k(-self._lr_power, p), _k(lr, p)
        pow2 = torch.pow(n2, lp)
        sigma = _div(pow2 - torch.pow(n, lp), lr_t)
        z2 = z + g - sigma * p
        l1 = _k(self._l1, p)
        p2 = torch.where(
            torch.abs(z2) <= l1, torch.zeros_like(p),
            -(z2 - torch.sign(z2) * l1)
            / (_div(pow2, lr_t) + _k(2 * self._l2, p)))
        return p2, {"squared": n2, "linear": z2}


class LarsMomentum(RuleOptimizer):
    """Layer-wise adaptive rate scaling over momentum (the reference's
    ``lars_momentum_op.cc``): each parameter's ``local_lr = lr *
    lars_coeff * |p| / (|g| + lars_weight_decay * |p| + epsilon)`` where
    both norms are positive, else ``lr``."""
    SLOTS = ("velocity",)

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 epsilon=1e-9, name=None, multi_precision=False):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_wd = lars_weight_decay
        self._eps = epsilon

    def rule(self, g, p, slots, lr, t):
        w_norm, g_norm = _norm(p), _norm(g)
        lr_t, wd = _k(lr, p), _k(self._lars_wd, p)
        local = (_host(torch.mul, lr_t, self._lars_coeff, p.dtype)
                 * w_norm) / (g_norm + wd * w_norm + _k(self._eps, p))
        local_lr = torch.where((w_norm > 0) & (g_norm > 0), local,
                               torch.full_like(local, lr_t))
        v = _k(self._momentum, p) * slots["velocity"] + \
            local_lr * (g + wd * p)
        return p - v, {"velocity": v}


class Dpsgd(RuleOptimizer):
    """Differentially private SGD: each gradient scaled to norm at most
    ``clip``, then Gaussian noise of deviation ``sigma * clip /
    batch_size`` added before ``p - lr*g``."""

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16,
                 sigma=1.0, parameters=None, seed=0, name=None,
                 multi_precision=False):
        super().__init__(learning_rate, parameters, name=name,
                         multi_precision=multi_precision)
        self._clip, self._batch, self._sigma = clip, batch_size, sigma
        self._seed = int(seed or 0)

    def noise(self, like, t):
        """Standard normal noise shaped and typed like ``like`` from the
        generator of step ``t``, seeded anew for each parameter (the same
        draws for every parameter of a step, as JAX's ``normal(
        fold_in(key, t), shape)``)."""
        gen = torch.Generator(device=like.device)
        gen.manual_seed(fold_in(self._seed, t))
        return torch.randn(like.shape, generator=gen, dtype=like.dtype,
                           device=like.device)

    def rule(self, g, p, slots, lr, t):
        gnorm = _norm(g)
        g = g / torch.clamp(_div(gnorm, _k(self._clip, p)), min=1.0)
        noise = _k(self._sigma * self._clip / self._batch, p) \
            * self.noise(g, t)
        return p - _k(lr, p) * (g + noise), slots
