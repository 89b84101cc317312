"""Fused optimizer updates over a list of parameters: the plain PyTorch
versions, the CUDA kernel wrappers, :func:`fused_adam_`,
:func:`fused_momentum_`, :func:`fused_sgd_` and :func:`fused_lamb_`.

Adam ports the dygraph Adam body of ``paddle_tpu/ops/pallas/
fused_optimizer.py`` (``_adam_kernel`` with ``dygraph=True``, reached
from ``fused_try_rule``) followed by AdamW's decoupled decay
(``paddle_tpu/optimizer/optimizer.py:133-134``). Per element, in f32,
in this order::

    m2 = b1*m + (1-b1)*g
    v2 = b2*v + ((1-b2)*g)*g
    p2 = p - (lr * (m2/c1)) / (sqrt(v2/c2) + eps)   c1 = 1-b1^t, c2 = 1-b2^t
    p3 = p2 - (lr*wd) * p                           the OLD p; wd = 0: p3 = p2

Momentum ports ``_momentum_kernel`` (the dygraph ``Momentum`` update
reached from ``fused_try_rule``)::

    v2 = mu*v + g
    p2 = p - lr*v2                  Nesterov: p2 = p - (g + mu*v2)*lr

SGD ports ``_sgd_kernel`` (the dygraph ``SGD`` update)::

    p2 = p - lr*g

Lamb ports ``_lamb_phase1_kernel`` with ``dygraph=True`` and the two
XLA steps the JAX package runs after it (``fused_try_rule``,
``fused_optimizer.py:600-613``), in three steps over every parameter::

    1. kernel:  m2 = b1*m + (1-b1)*g
                v2 = b2*v + ((1-b2)*g)*g
                r  = (m2/c1) / (sqrt(v2/c2) + eps) + wd*p     into scratch r
    2. PyTorch: w = |p|, q = |r| per tensor (torch._foreach_norm)
    3. kernel:  trust = w/q where w > 0 and q > 0, else 1
                p2 = p - (lr*trust)*r

so a step is two kernel launches and two foreach reductions, with no
host sync. ``r`` is a persistent f32 scratch per parameter that the
optimizer keeps. The norms are summed in another order than XLA's, so
against JAX the update holds to a tolerance; given the same norms the
kernels are bit for bit the plain version.

``skip`` (the FoundInfinite flag) leaves every tensor as it was. Unlike
the functional JAX update, parameters and state are updated IN PLACE.

The scalars (c1, c2, lr*wd, lr, mu, wd) are rounded to f32 once on the host
and handed to both versions; the plain versions multiply and divide by
0-dim tensors on the parameters' device (PyTorch's CUDA division by a
Python scalar is a reciprocal multiply) and the kernels use
round-to-nearest intrinsics without contraction, so each kernel agrees
with its plain version bit for bit on the card.

Routing is by device, with no fallback: CUDA tensors launch ONE kernel
over every parameter (a device table of pointers, cached while the
pointers stay the same) and count one ``fused_adam``,
``fused_momentum`` or ``fused_sgd`` launch (Lamb: one
``fused_lamb_phase1`` and one ``fused_lamb_apply``), or raise; CPU
tensors take the plain version. There is no size or dtype floor (the
JAX gate's n >= 1024 and f32-only rules were TPU tuning): every f32
parameter goes through the kernel.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build, counters

__all__ = ["adam_scalars", "fused_adam_", "fused_momentum_", "fused_sgd_",
           "fused_lamb_"]

_P = ctypes.c_void_p
_F = ctypes.c_float


def adam_scalars(lr, beta1, beta2, step, weight_decay=0.0):
    """(lr, c1, c2, lr*wd) as f32, the way the JAX update rounds them:
    ``c = 1 - b**t`` with b and t in f32, ``lr*wd`` an f32 product."""
    t = np.float32(step)
    lr32 = np.float32(lr)
    c1 = np.float32(1.0) - np.power(np.float32(beta1), t, dtype=np.float32)
    c2 = np.float32(1.0) - np.power(np.float32(beta2), t, dtype=np.float32)
    return lr32, np.float32(c1), np.float32(c2), \
        np.float32(lr32 * np.float32(weight_decay))


def _scalar(x, like):
    """``x`` as a 0-dim f32 tensor on ``like``'s device: PyTorch divides
    by it (where it would multiply by the reciprocal of a Python
    scalar on CUDA) and multiplies by it in f32, as the kernels do."""
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def _plain_adam_(params, grads, m1s, m2s, lr, beta1, beta2, eps, c1, c2,
                 lrwd, skip):
    if skip:
        return
    for p, g, m, v in zip(params, grads, m1s, m2s):
        def s(x):
            return _scalar(x, p)
        m_new = m * s(beta1) + g * s(1.0 - beta1)
        v_new = v * s(beta2) + (g * s(1.0 - beta2)) * g
        upd = (m_new / s(c1)) * s(lr) / (torch.sqrt(v_new / s(c2)) + s(eps))
        p_new = p - upd
        if lrwd != 0.0:
            p_new = p_new - s(lrwd) * p
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)


def _plain_momentum_(params, grads, velocities, lr, mu, nesterov, skip):
    if skip:
        return
    for p, g, v in zip(params, grads, velocities):
        def s(x):
            return _scalar(x, p)
        v_new = v * s(mu) + g
        if nesterov:
            p_new = p - (g + v_new * s(mu)) * s(lr)
        else:
            p_new = p - v_new * s(lr)
        p.copy_(p_new)
        v.copy_(v_new)


def _plain_sgd_(params, grads, lr, skip):
    if skip:
        return
    for p, g in zip(params, grads):
        p.copy_(p - _scalar(lr, p) * g)


def _plain_lamb_phase1_(params, grads, m1s, m2s, rs, beta1, beta2, eps, wd,
                        c1, c2):
    for p, g, m, v, r in zip(params, grads, m1s, m2s, rs):
        def s(x):
            return _scalar(x, p)
        m_new = m * s(beta1) + g * s(1.0 - beta1)
        v_new = v * s(beta2) + (g * s(1.0 - beta2)) * g
        r.copy_((m_new / s(c1)) / (torch.sqrt(v_new / s(c2)) + s(eps))
                + p * s(wd))
        m.copy_(m_new)
        v.copy_(v_new)


def _lamb_norms(params, rs):
    """(2n,) f32 on the parameters' device: the norm of each parameter,
    then the norm of each trust-ratio numerator ``r``."""
    return torch.stack(torch._foreach_norm(params) + torch._foreach_norm(rs))


def _plain_lamb_apply_(params, rs, norms, lr):
    n = len(params)
    w, q = norms[:n], norms[n:]
    trust = torch.where((w > 0) & (q > 0), w / q, torch.ones_like(w))
    scale = trust * _scalar(lr, trust)
    for i, (p, r) in enumerate(zip(params, rs)):
        p.copy_(p - scale[i] * r)


def _plain_lamb_(params, grads, m1s, m2s, rs, lr, beta1, beta2, eps, wd,
                 c1, c2, skip):
    if skip:
        return
    _plain_lamb_phase1_(params, grads, m1s, m2s, rs, beta1, beta2, eps, wd,
                        c1, c2)
    _plain_lamb_apply_(params, rs, _lamb_norms(params, rs), lr)


def _table(tensors_by_role, cache):
    """Device table of pointers ((roles, n) int64: p, g, then the rule's
    state) and the (n + 1,) element offsets, cached by the pointers
    themselves."""
    params = tensors_by_role[0]
    key = tuple(t.data_ptr() for role in tensors_by_role for t in role) \
        + tuple(p.numel() for p in params)
    hit = cache.get("key") == key
    if not hit:
        ptrs = torch.tensor([[t.data_ptr() for t in role]
                             for role in tensors_by_role], dtype=torch.int64)
        offs = torch.tensor(np.concatenate(
            [[0], np.cumsum([p.numel() for p in params])]),
            dtype=torch.int64)
        dev = params[0].device
        # pinned + non-blocking: no stream sync; the caching host
        # allocator keeps the staging block until the copy has run
        cache["key"] = key
        cache["ptrs"] = ptrs.pin_memory().to(dev, non_blocking=True)
        cache["offs"] = offs.pin_memory().to(dev, non_blocking=True)
        cache["total"] = int(offs[-1])
    return cache["ptrs"], cache["offs"], cache["total"]


def _check_cuda(op, roles):
    """Raise unless every tensor of ``roles`` ({role: [tensor, ...]}) is
    a contiguous f32 tensor on the first parameter's device, and the
    tensors of each parameter share its shape."""
    dev = roles["param"][0].device
    for role, ts in roles.items():
        for t in ts:
            if t.dtype != torch.float32 or t.device != dev \
                    or not t.is_contiguous():
                raise ValueError(f"{op} takes contiguous f32 tensors on "
                                 f"{dev}; a {role} is {t.dtype} on "
                                 f"{t.device}")
    for group in zip(*roles.values()):
        if len({tuple(t.shape) for t in group}) != 1:
            raise ValueError(f"{op}: shapes differ: "
                             f"{[tuple(t.shape) for t in group]}")


def _cuda_adam_(params, grads, m1s, m2s, lr, beta1, beta2, eps, c1, c2,
                lrwd, skip, cache):
    dev = params[0].device
    _check_cuda("fused_adam_", {"param": params, "grad": grads,
                                "moment1": m1s, "moment2": m2s})
    ptrs, offs, total = _table((params, grads, m1s, m2s), cache)
    fn = _build.entry("fused_optimizer", "fused_adam_f32",
                      [_P, _P, ctypes.c_int, ctypes.c_longlong]
                      + [_F] * 9 + [ctypes.c_int, _P])
    err = fn(ptrs.data_ptr(), offs.data_ptr(), len(params), total,
             float(lr), float(np.float32(beta1)),
             float(np.float32(1.0 - beta1)), float(np.float32(beta2)),
             float(np.float32(1.0 - beta2)), float(np.float32(eps)),
             float(c1), float(c2), float(lrwd), int(bool(skip)),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check("fused_optimizer", err, "fused_adam_f32")
    if not skip:   # a skipped step launches nothing
        counters.bump("fused_adam")


def _cuda_momentum_(params, grads, velocities, lr, mu, nesterov, skip,
                    cache):
    dev = params[0].device
    _check_cuda("fused_momentum_", {"param": params, "grad": grads,
                                    "velocity": velocities})
    ptrs, offs, total = _table((params, grads, velocities), cache)
    fn = _build.entry("fused_optimizer", "fused_momentum_f32",
                      [_P, _P, ctypes.c_int, ctypes.c_longlong, _F, _F,
                       ctypes.c_int, ctypes.c_int, _P])
    err = fn(ptrs.data_ptr(), offs.data_ptr(), len(params), total,
             float(lr), float(mu), int(bool(nesterov)), int(bool(skip)),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check("fused_optimizer", err, "fused_momentum_f32")
    if not skip:   # a skipped step launches nothing
        counters.bump("fused_momentum")


def _cuda_sgd_(params, grads, lr, skip, cache):
    dev = params[0].device
    _check_cuda("fused_sgd_", {"param": params, "grad": grads})
    ptrs, offs, total = _table((params, grads), cache)
    fn = _build.entry("fused_optimizer", "fused_sgd_f32",
                      [_P, _P, ctypes.c_int, ctypes.c_longlong, _F,
                       ctypes.c_int, _P])
    err = fn(ptrs.data_ptr(), offs.data_ptr(), len(params), total,
             float(lr), int(bool(skip)),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check("fused_optimizer", err, "fused_sgd_f32")
    if not skip:   # a skipped step launches nothing
        counters.bump("fused_sgd")


def _cuda_lamb_(params, grads, m1s, m2s, rs, lr, beta1, beta2, eps, wd, c1,
                c2, skip, cache):
    dev = params[0].device
    _check_cuda("fused_lamb_", {"param": params, "grad": grads,
                                "moment1": m1s, "moment2": m2s,
                                "trust_r": rs})
    if skip:       # a skipped step launches nothing
        return
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs, offs, total = _table((params, grads, m1s, m2s, rs),
                               cache.setdefault("phase1", {}))
    fn = _build.entry("fused_optimizer", "fused_lamb_phase1_f32",
                      [_P, _P, ctypes.c_int, ctypes.c_longlong]
                      + [_F] * 8 + [_P])
    err = fn(ptrs.data_ptr(), offs.data_ptr(), len(params), total,
             float(np.float32(beta1)), float(np.float32(1.0 - beta1)),
             float(np.float32(beta2)), float(np.float32(1.0 - beta2)),
             float(np.float32(eps)), float(np.float32(wd)), float(c1),
             float(c2), stream)
    _build.check("fused_optimizer", err, "fused_lamb_phase1_f32")
    counters.bump("fused_lamb_phase1")
    norms = _lamb_norms(params, rs)
    ptrs, offs, total = _table((params, rs), cache.setdefault("apply", {}))
    fn = _build.entry("fused_optimizer", "fused_lamb_apply_f32",
                      [_P, _P, ctypes.c_int, ctypes.c_longlong, _P, _F, _P])
    err = fn(ptrs.data_ptr(), offs.data_ptr(), len(params), total,
             norms.data_ptr(), float(lr), stream)
    _build.check("fused_optimizer", err, "fused_lamb_apply_f32")
    counters.bump("fused_lamb_apply")


def _device_of(op, params):
    dev = params[0].device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{op} runs on cuda or cpu, got {dev}")
    return dev


def fused_adam_(params, grads, moment1, moment2, *, lr, beta1, beta2, eps,
                step, weight_decay=0.0, skip=False, cache=None):
    """One Adam(W) step over lists of parameters, gradients and moments,
    IN PLACE. ``step`` is the 1-based step t; ``weight_decay`` is the
    decoupled (AdamW) coefficient. ``cache`` (a dict the caller owns)
    keeps the kernel's pointer table between calls."""
    params, grads = list(params), list(grads)
    moment1, moment2 = list(moment1), list(moment2)
    if not (len(params) == len(grads) == len(moment1) == len(moment2)):
        raise ValueError("fused_adam_: lists of different lengths")
    if not params:
        return
    lr32, c1, c2, lrwd = adam_scalars(lr, beta1, beta2, step, weight_decay)
    if _device_of("fused_adam_", params).type == "cuda":
        _cuda_adam_(params, grads, moment1, moment2, lr32, beta1, beta2,
                    eps, c1, c2, lrwd, skip, {} if cache is None else cache)
        return
    _plain_adam_(params, grads, moment1, moment2, lr32, beta1, beta2, eps,
                 c1, c2, lrwd, skip)


def fused_momentum_(params, grads, velocities, *, lr, momentum, nesterov,
                    skip=False, cache=None):
    """One Momentum step over lists of parameters, gradients and
    velocities, IN PLACE. ``cache`` (a dict the caller owns) keeps the
    kernel's pointer table between calls."""
    params, grads = list(params), list(grads)
    velocities = list(velocities)
    if not (len(params) == len(grads) == len(velocities)):
        raise ValueError("fused_momentum_: lists of different lengths")
    if not params:
        return
    lr32, mu32 = np.float32(lr), np.float32(momentum)
    if _device_of("fused_momentum_", params).type == "cuda":
        _cuda_momentum_(params, grads, velocities, lr32, mu32, nesterov,
                        skip, {} if cache is None else cache)
        return
    _plain_momentum_(params, grads, velocities, lr32, mu32, nesterov, skip)


def fused_sgd_(params, grads, *, lr, skip=False, cache=None):
    """One SGD step ``p - lr*g`` over lists of parameters and gradients,
    IN PLACE. ``cache`` (a dict the caller owns) keeps the kernel's
    pointer table between calls."""
    params, grads = list(params), list(grads)
    if len(params) != len(grads):
        raise ValueError("fused_sgd_: lists of different lengths")
    if not params:
        return
    lr32 = np.float32(lr)
    if _device_of("fused_sgd_", params).type == "cuda":
        _cuda_sgd_(params, grads, lr32, skip, {} if cache is None else cache)
        return
    _plain_sgd_(params, grads, lr32, skip)


def fused_lamb_(params, grads, moment1, moment2, trust_r, *, lr, beta1,
                beta2, eps, weight_decay, step, skip=False, cache=None):
    """One Lamb step over lists of parameters, gradients, moments and
    trust-ratio scratch tensors (f32, shaped like the parameters, their
    contents overwritten), IN PLACE. ``step`` is the 1-based step t;
    ``weight_decay`` is Lamb's own decay inside ``r``. ``cache`` (a dict
    the caller owns) keeps the kernels' pointer tables between calls."""
    lists = [list(x) for x in (params, grads, moment1, moment2, trust_r)]
    if len({len(x) for x in lists}) != 1:
        raise ValueError("fused_lamb_: lists of different lengths")
    params, grads, moment1, moment2, trust_r = lists
    if not params:
        return
    lr32, c1, c2, _ = adam_scalars(lr, beta1, beta2, step)
    args = (params, grads, moment1, moment2, trust_r, lr32, beta1, beta2,
            eps, weight_decay, c1, c2, skip)
    if _device_of("fused_lamb_", params).type == "cuda":
        _cuda_lamb_(*args, {} if cache is None else cache)
        return
    _plain_lamb_(*args)
