"""Meta-optimizers: wrappers that change the update schedule.

Port of ``paddle_tpu/optimizer/meta.py``: ``GradientMergeOptimizer``,
``recompute`` and the dygraph ``RecomputeOptimizer``, ``LookAhead``,
``DGCMomentum``, ``EMA`` and ``ModelAverage``, each over the port's
``Optimizer``. None has a TPU kernel (JAX runs them in XLA); here they
are PyTorch tensor operations on the parameters' device, updating IN
PLACE where JAX rebinds a parameter's value. ``LocalSGDOptimizer``
(``distributed/collective``) and ``PipelineOptimizer``
(``parallel/pipeline.py``) come with port slice 11 and raise; the static
path of ``RecomputeOptimizer.minimize`` comes with slice 9
(``static/backward.py``).
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.utils.checkpoint

from .. import amp as amp_mod
from ..framework import random as random_mod
from ..framework.tensor import EntryClass, entry, user_callback
from .optimizer import RuleOptimizer, _div, _k

__all__ = ["GradientMergeOptimizer", "recompute", "RecomputeOptimizer",
           "LookAhead", "LocalSGDOptimizer", "DGCMomentum", "EMA",
           "ModelAverage", "PipelineOptimizer"]


class GradientMergeOptimizer(EntryClass):
    """Accumulate the gradients of ``k_steps`` calls, then apply them
    once (``meta.py:17-75``): with ``avg`` the merged gradient is divided
    by ``k_steps`` once before the inner step; every gradient is cleared
    after each call, so a cycle's backward never sees the last cycle's
    gradient. ``step`` returns whether the inner optimizer stepped."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self.inner = inner_optimizer
        self.k_steps = k_steps
        self.avg = avg
        self._acc = {}
        self._count = 0

    @torch.no_grad()
    def step(self):
        params = self.inner._params()
        self._count += 1
        for p in params:
            if p.grad is None:
                continue
            acc = self._acc.get(id(p))
            self._acc[id(p)] = p.grad if acc is None else acc + p.grad
        if self._count < self.k_steps:
            for p in params:
                p.grad = None
            return False
        for p in params:
            g = self._acc.get(id(p))
            if g is not None:
                p.grad = _div(g, self.k_steps) if self.avg else g
        self.inner.step()
        for p in params:
            p.grad = None
        self._acc.clear()
        self._count = 0
        return True

    def minimize(self, loss, **kw):
        if loss is not None and loss.requires_grad:
            loss.backward()
        self.step()
        return None, None

    def clear_grad(self):
        self.inner.clear_grad()

    def __getattr__(self, item):
        return getattr(self.inner, item)


def _rng_snapshot():
    """What a replay of the segment must rewind: the innermost
    ``rng_scope``'s step generators (the flash kernels' dropout seeds and
    the dropout masks come from them), or, outside any scope, the global
    CPU generator that ``current_rng`` draws a fresh state from; and the
    AMP state (thread-local, and the backward runs on another thread)."""
    stack = getattr(random_mod._state, "stack", None)
    if stack:
        rng = stack[-1]
        gens = (rng.generator, rng._host)
    else:
        rng = None
        gens = (random_mod.default_generator("cpu"),)
    amp_state = tuple(getattr(amp_mod._state, k, d) for k, d in (
        ("level", "O0"), ("dtype", torch.bfloat16),
        ("white", amp_mod.WHITE_LIST), ("black", amp_mod.BLACK_LIST)))
    return rng, gens, [g.get_state() for g in gens], amp_state


@contextlib.contextmanager
def _replay(snapshot):
    """The segment's recomputation with the random state and AMP state of
    its forward run: the generators rewound to where the forward found
    them (so the kernels get the same seeds and dropout the same masks),
    then set back to where they were."""
    rng, gens, states, (level, dtype, white, black) = snapshot
    now = [g.get_state() for g in gens]
    cast = amp_mod.auto_cast(level=level)
    cast.dtype, cast.white, cast.black = dtype, white, black
    scope = random_mod.rng_scope(rng) if rng is not None \
        else contextlib.nullcontext()
    for g, s in zip(gens, states):
        g.set_state(s)
    try:
        with cast, scope:
            yield
    finally:
        for g, s in zip(gens, now):
            g.set_state(s)


def recompute(function, *args, **kwargs):
    """Activation rematerialization (``meta.py:91-193``): run
    ``function(*args, **kwargs)`` keeping only its inputs for the
    backward, which runs the segment again to rebuild its activations
    (``torch.utils.checkpoint`` without reentry, so the gradients flow
    through the same graph nodes, summed in the same order, as without
    recompute). The replay rewinds the port's random state and restores
    the AMP state of the forward run (``_replay``), as JAX rewinds its
    default generator (``:153``, ``:171``): the flash kernels get the
    same Philox seeds and the dropout masks are the same bits. Tensor
    keyword arguments raise ``ValueError``, as in JAX. A ``function``
    handed over by a user's code runs as a user's code, in the forward
    and in the replay."""
    return _recompute(user_callback(function), *args, **kwargs)


@entry
def _recompute(function, *args, **kwargs):
    for k, v in kwargs.items():
        if torch.is_tensor(v):
            raise ValueError(
                f"recompute: Tensor keyword argument {k!r} is not "
                "supported — pass tensors positionally so gradients "
                "flow through them")
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    snapshot = _rng_snapshot()
    return torch.utils.checkpoint.checkpoint(
        function, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _replay(snapshot)),
        **kwargs)


class RecomputeOptimizer(EntryClass):
    """``meta.py:194-…``, the dygraph path: ``_set_checkpoints`` takes
    sub-layers (or callables with a ``forward``) and wraps each one's
    ``forward`` in :func:`recompute` IN PLACE, so the next forward keeps
    only each checkpoint's inputs and the backward recomputes it; the
    step is the inner optimizer's. A static ``Variable`` loss raises:
    the static path is port slice 9."""

    def __init__(self, optimizer):
        self.inner = optimizer
        self._checkpoints = None
        self._wrapped = []

    def _set_checkpoints(self, checkpoints):
        self._unwrap_layers()
        self._checkpoints = list(checkpoints or [])
        for c in self._checkpoints:
            if callable(c) and not isinstance(c, str):
                self._wrap_layer(c)

    def _wrap_layer(self, layer):
        orig = layer.forward

        @functools.wraps(orig)
        def wrapped(*a, **k):
            return recompute(orig, *a, **k)

        layer.forward = wrapped
        self._wrapped.append((layer, orig))

    def _unwrap_layers(self):
        for layer, orig in self._wrapped:
            layer.forward = orig
        self._wrapped = []

    def step(self):
        self.inner.step()

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if not torch.is_tensor(loss):
            raise NotImplementedError(
                "RecomputeOptimizer.minimize on a static Variable: the "
                "static recompute path is port slice 9")
        return self.inner.minimize(loss)

    def clear_grad(self):
        self.inner.clear_grad()

    def __getattr__(self, item):
        return getattr(self.inner, item)


class LookAhead(EntryClass):
    """Lookahead (``meta.py:280-313``): every ``k`` inner steps the slow
    weights move ``alpha`` of the way to the fast ones, and the fast
    weights take the slow ones' value. The slow weights start as the
    fast weights of the first synchronisation."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._slow = {}
        self._n = 0

    def _params(self):
        return self.inner._params()

    @torch.no_grad()
    def step(self):
        self.inner.step()
        self._n += 1
        if self._n % self.k == 0:
            for p in self.inner._params():
                if id(p) not in self._slow:
                    self._slow[id(p)] = p.detach().clone()
                slow = self._slow[id(p)]
                slow.copy_(slow + _k(self.alpha, p) * (p - slow))
                p.copy_(slow)

    def minimize(self, loss, **kw):
        if loss is not None and loss.requires_grad:
            loss.backward()
        self.step()
        return None, None

    def clear_grad(self):
        self.inner.clear_grad()


class LocalSGDOptimizer(EntryClass):
    """LocalSGD averages the parameters across data-parallel workers
    every ``k_steps`` steps (``meta.py:316-360``): port slice 11, with
    ``distributed/collective``."""

    def __init__(self, inner_optimizer, k_steps=1, begin_step=1):
        raise NotImplementedError("LocalSGDOptimizer needs the port's "
                                  "distributed/collective: port slice 11")


class DGCMomentum(RuleOptimizer):
    """Deep gradient compression momentum (``meta.py:362-448``): before
    ``rampup_begin_step`` plain momentum; after it the momentum-corrected
    accumulator ``v`` sends only its entries with ``|v| >=`` the k-th
    largest ``|v|`` (k = max(1, int(n * (1 - sparsity))), ties kept) into
    the velocity, the rest stay in the residuals ``u``, ``v``. With
    several ``sparsity`` entries, each holds for ``rampup_step //
    len(sparsity)`` steps after ``rampup_begin_step``, the last one
    after that."""
    SLOTS = ("velocity", "u", "v")

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 rampup_begin_step=0, rampup_step=1, sparsity=(0.999,),
                 parameters=None, use_nesterov=False, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._rampup_begin = int(rampup_begin_step)
        self._sparsities = (tuple(float(s) for s in sparsity)
                            if isinstance(sparsity, (list, tuple))
                            else (float(sparsity),))
        self._rampup_step = max(1, int(rampup_step))
        self._nesterov = use_nesterov

    def sparsity_at(self, t):
        """The sparsity of step ``t`` (1-based), None before the
        warm-up's start (plain momentum)."""
        if self._rampup_begin > 0 and not t > self._rampup_begin:
            return None
        s = self._sparsities
        steps_per = max(1, self._rampup_step // len(s))
        phase = min(max((t - self._rampup_begin - 1) // steps_per, 0),
                    len(s) - 1)
        return s[phase]

    def mask(self, v, sparsity):
        """Where ``v`` is sent: ``|v| >=`` its k-th largest ``|v|``."""
        k = max(1, int(v.numel() * (1.0 - sparsity)))
        thr = torch.topk(torch.abs(v).reshape(-1), k).values[-1]
        return torch.abs(v) >= thr

    def rule(self, g, p, slots, lr, t):
        mu, lr_t = _k(self._momentum, p), _k(lr, p)
        sparsity = self.sparsity_at(t)
        if sparsity is None:
            vel = mu * slots["velocity"] + g
            d = g + mu * vel if self._nesterov else vel
            return p - lr_t * d, {"velocity": vel, "u": slots["u"],
                                  "v": slots["v"]}
        u = mu * slots["u"] + g
        v = slots["v"] + u
        mask = self.mask(v, sparsity)
        zero = torch.zeros_like(v)
        sent = torch.where(mask, v, zero)
        vel = mu * slots["velocity"] + sent
        d = sent + mu * vel if self._nesterov else vel
        return p - lr_t * d, {"velocity": vel,
                              "u": torch.where(mask, zero, u),
                              "v": torch.where(mask, zero, v)}


class EMA(EntryClass):
    """Exponential moving average of parameters (``meta.py:450-484``):
    ``update`` moves each average ``1 - d`` of the way to its parameter,
    ``d = min(decay, (1 + n) / (10 + n))`` at the n-th update; ``apply``
    swaps the averages into the parameters, ``restore`` swaps them
    back."""

    def __init__(self, decay=0.999, thres_steps=None):
        self._decay = decay
        self._ema = {}
        self._backup = {}
        self._step = 0
        self._params = []

    @torch.no_grad()
    def register(self, parameters):
        self._params = list(parameters)
        for p in self._params:
            self._ema[id(p)] = p.detach().clone()

    @torch.no_grad()
    def update(self):
        self._step += 1
        d = min(self._decay, (1 + self._step) / (10 + self._step))
        for p in self._params:
            if id(p) not in self._ema:
                self._ema[id(p)] = p.detach().clone()
            else:
                e = self._ema[id(p)]
                self._ema[id(p)] = _k(d, e) * e + _k(1 - d, p) * p.detach()

    @torch.no_grad()
    def apply(self, need_restore=True):
        for p in self._params:
            self._backup[id(p)] = p.detach().clone()
            p.copy_(self._ema[id(p)])

    @torch.no_grad()
    def restore(self):
        for p in self._params:
            if id(p) in self._backup:
                p.copy_(self._backup.pop(id(p)))


class ModelAverage(EMA):
    """The running mean of each parameter over every ``update``
    (``meta.py:487-500``): EMA's swap with uniform weights."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000000):
        super().__init__(decay=0.0)
        self._sum = {}
        self._count = 0

    @torch.no_grad()
    def update(self):
        self._count += 1
        for p in self._params:
            s = self._sum.get(id(p))
            s = p.detach().clone() if s is None else s + p.detach()
            self._sum[id(p)] = s
            self._ema[id(p)] = _div(s, self._count)


class PipelineOptimizer(EntryClass):
    """Pipeline-parallel training (``meta.py:503-553``): port slice 11,
    with ``parallel/pipeline.py``."""

    def __init__(self, optimizer, num_microbatches=1, start_cpu_core_id=0):
        raise NotImplementedError("PipelineOptimizer needs the port's "
                                  "parallel/pipeline.py: port slice 11")
