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

SGD ports ``_sgd_kernel`` (the dygraph ``SGD`` update) with the
coupled L2 term that the JAX optimizer adds to the gradient before it
(``L2Decay.grad_term``, ``paddle_tpu/optimizer/optimizer.py:102-104``)
folded in, each operation rounded on its own in this order::

    p2 = p - lr*(g + wd*p)          wd = 0: p2 = p - lr*g (no decay term)

Lamb ports ``_lamb_phase1_kernel`` with ``dygraph=True`` and the two
XLA steps the JAX package runs after it (``fused_try_rule``,
``fused_optimizer.py:600-613``), in two passes over every parameter::

    1. kernel:  m2 = b1*m + (1-b1)*g
                v2 = b2*v + ((1-b2)*g)*g
                r  = (m2/c1) / (sqrt(v2/c2) + eps) + wd*p     into scratch r
                and each tensor's sums of p*p and r*r: one block a piece
                (:func:`lamb_pieces`), a fixed reduction tree, then the
                pieces of a tensor added in a fixed order in f64
    2. kernel:  w = sqrt(sum p*p), q = sqrt(sum r*r)
                trust = w/q where w > 0 and q > 0, else 1
                p2 = p - (lr*trust)*r

so a step is two counted launches (phase 1 is two kernels, counted as
one) moving 40 bytes an element, with no host sync and no float
atomics. ``r`` is a persistent f32 scratch per parameter that the
optimizer keeps. The plain version takes its norms with
``torch._foreach_norm``; the norms are summed in other orders than the
kernel's and XLA's, so against either the update holds to a tolerance.
m, v and r are the plain version's bit for bit, and given the kernel's
norms (:func:`lamb_kernel_norms`) so is p.

The master-weight forms (``masters=`` a list of f32 tensors, one a
parameter; ``amp.decorate(level="O2")`` and ``multi_precision=True``)
take bf16 or f16 parameters and gradients. They port the JAX package's
multi-precision update (``paddle_tpu/optimizer/optimizer.py:115-128``):
``g.astype(f32)``, the rule above on the f32 master in the parameter's
place (Lamb's norms are the master's), then ``master.astype(p.dtype)``
into the parameter, rounded to nearest even. On the card that is one
launch over every parameter (Lamb: the same two), counted
``fused_adam_master``, ``fused_momentum_master``, ``fused_sgd_master``,
``fused_lamb_phase1_master`` and ``fused_lamb_apply_master``; the plain
versions run the f32 plain versions on the masters with the gradients
upcast, then copy each master into its parameter. SGD's master form adds
its coupled L2 term as the JAX optimizer does before the upcast: ``g +
wd*p`` from the 2-byte parameter, each operation rounded to its type
(``wd`` rounded to it first). Bytes an element stay the f32 forms':
Adam 28, Momentum 20, SGD 12 (14 with the decay), Lamb 40.

The 2-byte forms without masters (bf16 or f16 parameters, ``masters``
None: ``multi_precision=False``, ``amp.decorate(master_weight=False)``)
keep the state and Lamb's ``r`` in the parameters' type. No TPU kernel
covers them: the JAX package sends every non-f32 update to XLA
(``paddle_tpu/ops/pallas/fused_optimizer.py:305-306``), which runs the
optimizer's ``rule`` in the parameter's type (``paddle_tpu/optimizer/
optimizer.py:131-134``), each operation yielding that type; the kernels
here port that XLA code, each operation one f32 operation rounded to the
type, in the rule's order (``csrc/fused_optimizer.cu``, the block above
``Adam2Rule``), the scalars rounded to the type first
(:func:`adam_scalars_2byte`, ``regularizer.in_type``). Lamb's norms are square
roots of sums of squares rounded to the type, the sums taken in f32
and f64 and rounded to the type (``jnp.sum`` over a 2-byte array). The
plain versions (``_plain_*_2byte_``) compute in the type op by op, the
scalars as 0-dim tensors of the type; XLA on the CPU rounds bf16 after
each operation too (the CPU tests hold the plain versions to JAX bit
for bit in bf16; in f16 XLA keeps a fused chain in f32, so f16 is held
element by element). On the card one launch over every parameter
(Lamb: two), counted ``fused_adam_bf16`` / ``_f16``,
``fused_momentum_*``, ``fused_sgd_*``, ``fused_lamb_phase1_*`` and
``fused_lamb_apply_*``; bytes an element: Adam 14, Momentum 10, SGD 6,
Lamb 20 (14 for the function).

``skip`` (the FoundInfinite flag) leaves every tensor as it was. Unlike
the functional JAX update, parameters and state are updated IN PLACE.

The scalars (c1, c2, lr*wd, lr, mu, wd) are rounded to f32 once on the host
and handed to both versions; the plain versions multiply and divide by
0-dim tensors on the parameters' device (PyTorch's CUDA division by a
Python scalar is a reciprocal multiply) and the kernels use
round-to-nearest intrinsics without contraction, so each kernel agrees
with its plain version bit for bit on the card.

Routing is by device, with no fallback: CUDA tensors launch ONE kernel
over every parameter and count one ``fused_adam``, ``fused_momentum``
or ``fused_sgd`` launch (Lamb: one ``fused_lamb_phase1`` and one
``fused_lamb_apply``), or raise; CPU tensors take the plain version.
Adam, Momentum and Lamb read a device table of pointers, cached while
the pointers stay the same; SGD's table travels by value in the
launch's parameters, as the static forms' do, so a step makes no
host-to-device copy and a list longer than ``static_capacity(2)``
tensors is cut into consecutive launches (:func:`table_splits`), each
counted. There is no size or dtype floor (the
JAX gate's n >= 1024 and f32-only rules were TPU tuning): every f32
parameter goes through the kernel.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...regularizer import in_type
from . import _build, counters

__all__ = ["adam_scalars", "adam_scalars_2byte", "decay_in",
           "fused_adam_", "fused_momentum_", "fused_sgd_",
           "fused_lamb_", "static_sgd_", "static_momentum_", "static_adam_",
           "static_lamb_", "static_sgd_list_", "static_momentum_list_",
           "static_adam_list_", "static_lamb_list_", "static_capacity",
           "static_param_bytes", "table_splits", "LAMB_PIECE", "lamb_pieces",
           "lamb_kernel_norms", "lamb_kernel_sums", "CHUNK_PIECE",
           "CHUNK_SPREAD", "chunk_piece", "chunk_segments", "chunk_pieces",
           "chunk_lamb_", "chunk_update"]

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


TWO_BYTE = {torch.bfloat16: "bf16", torch.float16: "f16"}


def _upcast(grads):
    return [g.to(torch.float32) for g in grads]


def _cast_down_(params, masters):
    """Each 2-byte parameter set to its master's round-to-nearest-even
    cast (``master.astype(p.dtype)``)."""
    for p, w in zip(params, masters):
        p.copy_(w)


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


def _plain_sgd_(params, grads, lr, wd, skip):
    if skip:
        return
    for p, g in zip(params, grads):
        if wd != 0.0:
            g = g + _scalar(wd, p) * p
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


# ---------------------------------------------------------------------------
# The 2-byte forms without masters: every tensor (parameter, gradient,
# state, Lamb's r) in the parameters' bf16 or f16 type, each operation
# of JAX's rule rounded to it (see the module docstring)
# ---------------------------------------------------------------------------
def adam_scalars_2byte(dtype, lr, beta1, beta2, eps, step,
                       weight_decay=0.0):
    """Adam's nine scalars (lr, b1, 1-b1, b2, 1-b2, eps, c1, c2, lr*wd)
    rounded to ``dtype`` as JAX's rule over a 2-byte parameter rounds
    them: ``lr`` an array of the type, the Python floats weak, c1 and c2
    the f32 ``1 - b**t`` cast to the type, lr*wd the rounded product of
    the rounded lr and wd."""
    def r(x):
        return in_type(x, dtype)

    lr32, c1, c2, _ = adam_scalars(lr, beta1, beta2, step)
    lr_t = r(lr32)
    lrwd = r(lr_t * r(weight_decay)) if weight_decay else 0.0
    return (lr_t, r(beta1), r(1.0 - beta1), r(beta2), r(1.0 - beta2),
            r(eps), r(c1), r(c2), lrwd)


def _typed(x, like):
    """``x`` as a 0-dim tensor of ``like``'s type and device: an operation
    with it rounds to that type (a Python scalar would enter PyTorch's
    f32 arithmetic unrounded, and CUDA divides by a Python scalar as a
    reciprocal product)."""
    return torch.tensor(float(x), dtype=like.dtype, device=like.device)


def _plain_adam_2byte_(params, grads, m1s, m2s, sc, skip):
    """Adam(W) in the parameters' 2-byte type, ``sc`` the nine scalars
    of :func:`adam_scalars_2byte`; each operation rounds to the type."""
    if skip:
        return
    lr, b1, omb1, b2, omb2, eps, c1, c2, lrwd = sc
    for p, g, m, v in zip(params, grads, m1s, m2s):
        def s(x):
            return _typed(x, p)
        m_new = s(b1) * m + s(omb1) * g
        v_new = s(b2) * v + s(omb2) * (g * g)
        den = torch.sqrt(v_new / s(c2)) + s(eps)
        p_new = p - (s(lr) * (m_new / s(c1))) / den
        if lrwd != 0.0:
            p_new = p_new - s(lrwd) * p
        p.copy_(p_new)
        m.copy_(m_new)
        v.copy_(v_new)


def _plain_momentum_2byte_(params, grads, velocities, lr, mu, nesterov,
                           skip):
    """Momentum in the parameters' 2-byte type (``lr``, ``mu`` rounded
    to it); each operation rounds to the type."""
    if skip:
        return
    for p, g, v in zip(params, grads, velocities):
        v_new = _typed(mu, p) * v + g
        d = g + _typed(mu, p) * v_new if nesterov else v_new
        p.copy_(p - _typed(lr, p) * d)
        v.copy_(v_new)


def _plain_sgd_2byte_(params, grads, lr, wd, skip):
    """SGD in the parameters' 2-byte type, ``p - lr*(g + wd*p)`` (the
    decay term left out at wd 0), each operation rounded to the type."""
    if skip:
        return
    for p, g in zip(params, grads):
        if wd != 0.0:
            g = g + _typed(wd, p) * p
        p.copy_(p - _typed(lr, p) * g)


def _plain_lamb_phase1_2byte_(params, grads, m1s, m2s, rs, sc, wd):
    """Lamb's phase 1 in the parameters' 2-byte type (m, v and r
    written), ``sc`` as :func:`adam_scalars_2byte` (lr unused) and
    ``wd`` rounded to the type."""
    _, b1, omb1, b2, omb2, eps, c1, c2, _ = sc
    for p, g, m, v, r in zip(params, grads, m1s, m2s, rs):
        def s(x):
            return _typed(x, p)
        m_new = s(b1) * m + s(omb1) * g
        v_new = s(b2) * v + s(omb2) * (g * g)
        den = torch.sqrt(v_new / s(c2)) + s(eps)
        r.copy_((m_new / s(c1)) / den + s(wd) * p)
        m.copy_(m_new)
        v.copy_(v_new)


def _lamb_sums_2byte(params, rs):
    """(2n,) f32: each parameter's sum of its squares rounded to its type
    (``jnp.sum(jnp.square(p))``), then each r's, summed in f64."""
    return torch.stack([(x * x).double().sum() for x in params + rs]).float()


def _plain_lamb_apply_2byte_(params, rs, sums, lr):
    """Lamb's apply in the parameters' 2-byte type from ``sums`` (as
    :func:`_lamb_sums_2byte` gives them, or the kernel's,
    :func:`lamb_kernel_sums`): each sum rounded to the type, its square
    root, the trust ratio, ``lr*trust`` and the update, each rounded."""
    n = len(params)
    dt = params[0].dtype
    norms = torch.sqrt(sums.to(dt))
    w, q = norms[:n], norms[n:]
    trust = torch.where((w > 0) & (q > 0), w / q, torch.ones_like(w))
    scale = _typed(lr, trust) * trust
    for i, (p, r) in enumerate(zip(params, rs)):
        p.copy_(p - scale[i] * r)


def _plain_lamb_2byte_(params, grads, m1s, m2s, rs, sc, wd, skip):
    if skip:
        return
    _plain_lamb_phase1_2byte_(params, grads, m1s, m2s, rs, sc, wd)
    _plain_lamb_apply_2byte_(params, rs, _lamb_sums_2byte(params, rs), sc[0])


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


def _check_cuda(op, roles, form):
    """Raise unless every tensor of ``roles`` ({role: [tensor, ...]}) is
    a contiguous tensor on the first parameter's device of the type the
    ``form`` (:func:`_form`) gives its role: the parameters' and
    gradients' type, else the state's; and the tensors of each
    parameter share its shape."""
    dev = roles["param"][0].device
    _, _, ptype, stype = form
    short = {**TWO_BYTE, torch.float32: "f32"}
    for role, ts in roles.items():
        want = ptype if role in ("param", "grad") else stype
        for t in ts:
            if t.dtype != want or t.device != dev or not t.is_contiguous():
                raise ValueError(f"{op} takes contiguous tensors on {dev}: "
                                 f"parameters and gradients "
                                 f"{short[ptype]}, the rest {short[stype]} "
                                 f"(f32, a master form, or a 2-byte form "
                                 f"without masters); a {role} is {t.dtype} "
                                 f"on {t.device}")
    for group in zip(*roles.values()):
        if len({tuple(t.shape) for t in group}) != 1:
            raise ValueError(f"{op}: shapes differ: "
                             f"{[tuple(t.shape) for t in group]}")


def _form(params, masters):
    """(entry-point suffix, counter suffix, parameter type, state type):
    the f32 form; the master form of the parameters' 2-byte type (f32
    masters and state, counted ``_master``); or the 2-byte form without
    masters (everything in the parameters' type, counted ``_bf16`` or
    ``_f16``)."""
    dt = params[0].dtype
    if masters is not None:
        if dt not in TWO_BYTE:
            raise ValueError(f"a master-weight form takes bf16 or f16 "
                             f"parameters, got {dt}")
        return TWO_BYTE[dt], "_master", dt, torch.float32
    if dt in TWO_BYTE:
        return "nomaster_" + TWO_BYTE[dt], "_" + TWO_BYTE[dt], dt, dt
    return "f32", "", torch.float32, torch.float32


def _cuda_adam_(params, grads, m1s, m2s, sc, skip, cache, masters=None):
    dev = params[0].device
    roles = {"param": params, "grad": grads, "moment1": m1s, "moment2": m2s}
    if masters is not None:
        roles["master"] = masters
    form = _form(params, masters)
    _check_cuda("fused_adam_", roles, form)
    kind, tag = form[:2]
    lead = (params, grads) if masters is None else (params, grads, masters)
    ptrs, offs, total = _table(lead + (m1s, m2s), cache)
    fn = _build.entry("fused_optimizer", "fused_adam_" + kind,
                      [_P, _P, ctypes.c_int, ctypes.c_longlong]
                      + [_F] * 9 + [ctypes.c_int, _P])
    err = fn(ptrs.data_ptr(), offs.data_ptr(), len(params), total,
             *[float(x) for x in sc], int(bool(skip)),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check("fused_optimizer", err, "fused_adam_" + kind)
    if not skip:   # a skipped step launches nothing
        counters.bump("fused_adam" + tag)


def _cuda_momentum_(params, grads, velocities, lr, mu, nesterov, skip,
                    cache, masters=None):
    dev = params[0].device
    roles = {"param": params, "grad": grads, "velocity": velocities}
    if masters is not None:
        roles["master"] = masters
    form = _form(params, masters)
    _check_cuda("fused_momentum_", roles, form)
    kind, tag = form[:2]
    lead = (params, grads) if masters is None else (params, grads, masters)
    ptrs, offs, total = _table(lead + (velocities,), cache)
    fn = _build.entry("fused_optimizer", "fused_momentum_" + kind,
                      [_P, _P, ctypes.c_int, ctypes.c_longlong, _F, _F,
                       ctypes.c_int, ctypes.c_int, _P])
    err = fn(ptrs.data_ptr(), offs.data_ptr(), len(params), total,
             float(lr), float(mu), int(bool(nesterov)), int(bool(skip)),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check("fused_optimizer", err, "fused_momentum_" + kind)
    if not skip:   # a skipped step launches nothing
        counters.bump("fused_momentum" + tag)


def _cuda_sgd_(params, grads, lr, wd, skip, masters=None):
    roles = {"param": params, "grad": grads}
    if masters is not None:
        roles["master"] = masters
    form = _form(params, masters)
    _check_cuda("fused_sgd_", roles, form)
    kind, tag = form[:2]
    numels = [p.numel() for p in params]
    launches = 0
    if not skip:   # a skipped step launches nothing
        launches = _launch_args("fused_sgd_" + kind, list(roles.values()),
                                numels, (_F, _F), (float(lr), float(wd)),
                                "fused_sgd" + tag)
    return {"tensors": len(params), "elements": sum(numels),
            "launches": launches}


# elements a block of dygraph Lamb's phase 1 takes: the walker's chunk
LAMB_PIECE = 8192


def lamb_pieces(numels, piece: int = LAMB_PIECE):
    """Dygraph Lamb's piece table over parameters of ``numels``
    elements, in order: ``(pieces, tensor_first)``, ``pieces`` (m, 3)
    int64 rows (start in the concatenation, length, tensor), each a run
    of at most ``piece`` elements of one tensor starting at a multiple
    of ``piece`` of it; tensor t's pieces are rows ``tensor_first[t]:
    tensor_first[t + 1]``. The chunk entry's cut (:func:`chunk_pieces`)
    over the whole concatenation; an empty tensor has no piece."""
    pieces, first = chunk_pieces(numels, 0, int(sum(numels)), piece)
    return pieces, first[:len(numels) + 1]


def _lamb_tables(params, cache):
    """The piece table, each tensor's first piece, the (m, 2) piece-sum
    scratch and the (n, 2) sums of p*p and r*r on the parameters'
    device, made once per list of sizes and kept in ``cache``."""
    key = tuple(p.numel() for p in params)
    if cache.get("pieces_key") != key:
        dev = params[0].device
        pieces, first = lamb_pieces(key)
        cache["pieces_key"] = key
        cache["pieces"] = torch.from_numpy(pieces).pin_memory().to(
            dev, non_blocking=True)
        cache["tensor_first"] = torch.from_numpy(first).pin_memory().to(
            dev, non_blocking=True)
        cache["piece_sums"] = torch.empty(len(pieces), 2,
                                          dtype=torch.float32, device=dev)
        cache["sums"] = torch.empty(len(key), 2, dtype=torch.float32,
                                    device=dev)
    return (cache["pieces"], cache["tensor_first"], cache["piece_sums"],
            cache["sums"])


def lamb_kernel_norms(cache):
    """The norms the last card step of :func:`fused_lamb_` with this
    ``cache`` used: (2n,) f32, |p| of each parameter before the step,
    then |r| of each, as ``_plain_lamb_apply_`` takes them (square roots
    of phase 1's sums, rounded as the apply kernel rounds them)."""
    return torch.sqrt(cache["phase1"]["sums"]).t().reshape(-1)


def lamb_kernel_sums(cache):
    """The sums of squares the last card step of :func:`fused_lamb_` with
    this ``cache`` took: (2n,) f32, sum p*p of each parameter, then sum
    r*r of each, as ``_plain_lamb_apply_2byte_`` takes them (the 2-byte
    form rounds them to its type before the square root)."""
    return cache["phase1"]["sums"].t().reshape(-1)


def _cuda_lamb_(params, grads, m1s, m2s, rs, sc, wd, skip, cache,
                masters=None):
    dev = params[0].device
    roles = {"param": params, "grad": grads, "moment1": m1s, "moment2": m2s,
             "trust_r": rs}
    if masters is not None:
        roles["master"] = masters
    form = _form(params, masters)
    _check_cuda("fused_lamb_", roles, form)
    if skip:       # a skipped step launches nothing
        return
    kind, tag = form[:2]
    lr, b1, omb1, b2, omb2, eps, c1, c2, _ = sc
    weights = params if masters is None else masters
    stream = torch.cuda.current_stream(dev).cuda_stream
    phase1 = cache.setdefault("phase1", {})
    ptrs, offs, total = _table((weights, grads, m1s, m2s, rs), phase1)
    pieces, first, piece_sums, sums = _lamb_tables(weights, phase1)
    fn = _build.entry("fused_optimizer", "fused_lamb_phase1_" + kind,
                      [_P, _P, ctypes.c_int, ctypes.c_longlong, _P,
                       ctypes.c_int, _P, _P, _P] + [_F] * 8 + [_P])
    err = fn(ptrs.data_ptr(), offs.data_ptr(), len(params), total,
             pieces.data_ptr(), pieces.shape[0], first.data_ptr(),
             piece_sums.data_ptr(), sums.data_ptr(),
             *[float(x) for x in (b1, omb1, b2, omb2, eps, wd, c1, c2)],
             stream)
    _build.check("fused_optimizer", err, "fused_lamb_phase1_" + kind)
    counters.bump("fused_lamb_phase1" + tag)
    apply_roles = (params, rs) if masters is None else (params, rs, masters)
    ptrs, offs, total = _table(apply_roles, cache.setdefault("apply", {}))
    fn = _build.entry("fused_optimizer", "fused_lamb_apply_" + kind,
                      [_P, _P, ctypes.c_int, ctypes.c_longlong, _P, _F, _P])
    err = fn(ptrs.data_ptr(), offs.data_ptr(), len(params), total,
             sums.data_ptr(), float(lr), stream)
    _build.check("fused_optimizer", err, "fused_lamb_apply_" + kind)
    counters.bump("fused_lamb_apply" + tag)


def _device_of(op, params):
    dev = params[0].device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{op} runs on cuda or cpu, got {dev}")
    return dev


def _lists(op, masters, *lists):
    lists = [list(x) for x in lists]
    if masters is not None:
        lists.append(list(masters))
    if len({len(x) for x in lists}) != 1:
        raise ValueError(f"{op}: lists of different lengths")
    return lists


def _own_2byte(params, masters):
    """Whether a call takes the 2-byte form without masters."""
    return masters is None and params[0].dtype in TWO_BYTE


def _f32_adam_scalars(lr, beta1, beta2, eps, step, weight_decay):
    """The f32 and master forms' nine Adam scalars, rounded to f32."""
    lr32, c1, c2, lrwd = adam_scalars(lr, beta1, beta2, step, weight_decay)
    return (lr32, np.float32(beta1), np.float32(1.0 - beta1),
            np.float32(beta2), np.float32(1.0 - beta2), np.float32(eps), c1,
            c2, lrwd)


def fused_adam_(params, grads, moment1, moment2, *, lr, beta1, beta2, eps,
                step, weight_decay=0.0, skip=False, cache=None, masters=None):
    """One Adam(W) step over lists of parameters, gradients and moments,
    IN PLACE. ``step`` is the 1-based step t; ``weight_decay`` is the
    decoupled (AdamW) coefficient, applied to the master with the old
    master in the master form. ``cache`` (a dict the caller owns) keeps
    the kernel's pointer table between calls. ``masters``: the f32
    masters of bf16/f16 parameters (the master-weight form); bf16/f16
    parameters without masters take the 2-byte form (moments of their
    type)."""
    params, grads, moment1, moment2, *ms = _lists(
        "fused_adam_", masters, params, grads, moment1, moment2)
    masters = ms[0] if ms else None
    if not params:
        return
    own = _own_2byte(params, masters)
    sc = adam_scalars_2byte(params[0].dtype, lr, beta1, beta2, eps, step,
                            weight_decay) if own else \
        _f32_adam_scalars(lr, beta1, beta2, eps, step, weight_decay)
    if _device_of("fused_adam_", params).type == "cuda":
        _cuda_adam_(params, grads, moment1, moment2, sc, skip,
                    {} if cache is None else cache, masters)
        return
    lr32, _, _, _, _, _, c1, c2, lrwd = sc
    if own:
        _plain_adam_2byte_(params, grads, moment1, moment2, sc, skip)
    elif masters is None:
        _plain_adam_(params, grads, moment1, moment2, lr32, beta1, beta2,
                     eps, c1, c2, lrwd, skip)
    elif not skip:
        _plain_adam_(masters, _upcast(grads), moment1, moment2, lr32, beta1,
                     beta2, eps, c1, c2, lrwd, False)
        _cast_down_(params, masters)


def fused_momentum_(params, grads, velocities, *, lr, momentum, nesterov,
                    skip=False, cache=None, masters=None):
    """One Momentum step over lists of parameters, gradients and
    velocities, IN PLACE. ``cache`` (a dict the caller owns) keeps the
    kernel's pointer table between calls. ``masters``: the f32 masters
    of bf16/f16 parameters (the master-weight form); bf16/f16
    parameters without masters take the 2-byte form (velocities of
    their type, lr and mu rounded to it)."""
    params, grads, velocities, *ms = _lists(
        "fused_momentum_", masters, params, grads, velocities)
    masters = ms[0] if ms else None
    if not params:
        return
    own = _own_2byte(params, masters)
    if own:
        dt = params[0].dtype
        lr32, mu32 = in_type(lr, dt), in_type(momentum, dt)
    else:
        lr32, mu32 = np.float32(lr), np.float32(momentum)
    if _device_of("fused_momentum_", params).type == "cuda":
        _cuda_momentum_(params, grads, velocities, lr32, mu32, nesterov,
                        skip, {} if cache is None else cache, masters)
        return
    if own:
        _plain_momentum_2byte_(params, grads, velocities, lr32, mu32,
                               nesterov, skip)
    elif masters is None:
        _plain_momentum_(params, grads, velocities, lr32, mu32, nesterov,
                         skip)
    elif not skip:
        _plain_momentum_(masters, _upcast(grads), velocities, lr32, mu32,
                         nesterov, False)
        _cast_down_(params, masters)


def decay_in(dtype, weight_decay) -> float:
    """``weight_decay`` rounded to ``dtype`` (``jnp.asarray(coeff,
    p.dtype)``), as a Python float."""
    return in_type(weight_decay, dtype)


def _plain_decay_2byte(params, grads, wd):
    """``g + wd*p`` in the parameters' 2-byte type, each operation
    rounded to it (``L2Decay.grad_term`` on a bf16/f16 parameter)."""
    return [g + torch.tensor(wd, dtype=p.dtype, device=p.device) * p
            for p, g in zip(params, grads)]


def fused_sgd_(params, grads, *, lr, weight_decay=0.0, skip=False,
               masters=None):
    """One SGD step ``p - lr*(g + weight_decay*p)`` over lists of
    parameters and gradients, IN PLACE. ``weight_decay`` is the coupled
    L2 coefficient (0: ``p - lr*g``). ``masters``: the f32 masters of
    bf16/f16 parameters (the master-weight form); bf16/f16 parameters
    without masters take the 2-byte form (lr and the decay rounded to
    their type). On the card, returns what the launches covered:
    ``{"tensors", "elements", "launches"}``; on the CPU (the plain
    version) or for no parameters, None."""
    params, grads, *ms = _lists("fused_sgd_", masters, params, grads)
    masters = ms[0] if ms else None
    if not params:
        return None
    own = _own_2byte(params, masters)
    dt = params[0].dtype
    lr32 = in_type(lr, dt) if own else np.float32(lr)
    wd32 = np.float32(weight_decay) if masters is None and not own \
        or not weight_decay else np.float32(decay_in(dt, weight_decay))
    if _device_of("fused_sgd_", params).type == "cuda":
        return _cuda_sgd_(params, grads, lr32, wd32, skip, masters)
    if own:
        _plain_sgd_2byte_(params, grads, lr32, float(wd32), skip)
    elif masters is None:
        _plain_sgd_(params, grads, lr32, wd32, skip)
    elif not skip:
        if wd32 != 0.0:
            grads = _plain_decay_2byte(params, grads, float(wd32))
        _plain_sgd_(masters, _upcast(grads), lr32, np.float32(0.0), False)
        _cast_down_(params, masters)
    return None


def fused_lamb_(params, grads, moment1, moment2, trust_r, *, lr, beta1,
                beta2, eps, weight_decay, step, skip=False, cache=None,
                masters=None):
    """One Lamb step over lists of parameters, gradients, moments and
    trust-ratio scratch tensors (shaped like the parameters, of the
    state's type, their contents overwritten), IN PLACE. ``step`` is the
    1-based step t; ``weight_decay`` is Lamb's own decay inside ``r``.
    ``cache`` (a dict the caller owns) keeps the kernels' pointer tables
    between calls. ``masters``: the f32 masters of bf16/f16 parameters
    (the master-weight form; the norms are the masters'); bf16/f16
    parameters without masters take the 2-byte form (moments and r of
    their type)."""
    params, grads, moment1, moment2, trust_r, *ms = _lists(
        "fused_lamb_", masters, params, grads, moment1, moment2, trust_r)
    masters = ms[0] if ms else None
    if not params:
        return
    own = _own_2byte(params, masters)
    if own:
        dt = params[0].dtype
        sc = adam_scalars_2byte(dt, lr, beta1, beta2, eps, step)
        wd = in_type(weight_decay, dt)
    else:
        sc = _f32_adam_scalars(lr, beta1, beta2, eps, step, 0.0)
        wd = np.float32(weight_decay)
    if _device_of("fused_lamb_", params).type == "cuda":
        _cuda_lamb_(params, grads, moment1, moment2, trust_r, sc, wd, skip,
                    {} if cache is None else cache, masters)
        return
    if own:
        _plain_lamb_2byte_(params, grads, moment1, moment2, trust_r, sc, wd,
                           skip)
        return
    lr32, _, _, _, _, _, c1, c2, _ = sc
    rest = (moment1, moment2, trust_r, lr32, beta1, beta2, eps,
            weight_decay, c1, c2)
    if masters is None:
        _plain_lamb_(params, grads, *rest, skip)
    elif not skip:
        _plain_lamb_(masters, _upcast(grads), *rest, False)
        _cast_down_(params, masters)


# ---------------------------------------------------------------------------
# The static (program) forms: a run of update ops a call, scalars on the
# device
# ---------------------------------------------------------------------------
# The update ops of a static program (``static/kernels.py`` sgd, momentum,
# adam, lamb) port ``fused_op_update`` (``paddle_tpu/ops/pallas/
# fused_optimizer.py:418``): ``_run_grid`` with ``_sgd_kernel``,
# ``_momentum_kernel``, ``_adam_kernel`` and ``_lamb_phase1_kernel`` with
# ``dygraph=False``, which the JAX package runs one op (one grid) per
# parameter. The port's executor hands a RUN of consecutive update ops of
# one type and attrs to the list forms (``static_*_list_``), which update
# every parameter of the run in one launch (more where the run outgrows
# the table the launch carries by value, :func:`static_capacity`); the
# one-tensor forms are runs of one. Their scalars are
# the program's persistable (1,) variables: ``lr`` (LearningRate), the
# beta-pows ``b1p``/``b2p`` (Beta1Pow/Beta2Pow, one pair per parameter)
# and the optional bool ``found`` (FoundInfinite); the kernels read them
# from the device and the plain versions compute with them as tensors, so
# neither reads them on the host. Per element, in f32, JAX's order::
#
#     sgd:       p2 = p - lr*g
#     momentum:  v2 = mu*v + g;  p2 = p - lr*v2   (Nesterov: p - (g + mu*v2)*lr)
#     adam:      c1 = b1p*b1, c2 = b2p*b2            (the advanced pows)
#                m2 = b1*m + (1-b1)*g;  v2 = b2*v + ((1-b2)*g)*g
#                lr_t = lr*sqrt(1-c2)/(1-c1)
#                p2 = p - (lr_t*m2)/(sqrt(v2) + eps)
#     lamb:      m2, v2 as adam;  r = (m2/(1-c1))/(sqrt(v2/(1-c2)) + eps) + wd*p
#                w = |p|, q = |r|  (torch._foreach_norm, between two launches)
#                p2 = p - (lr*trust)*r,  trust = w/q where both > 0, else 1
#
# A set ``found`` keeps p and the moments or the velocity; Adam and Lamb
# return their pows' outputs (c1, c2, or the old pows under the flag) as
# NEW one-element tensors: the program writes Beta1PowOut to the variable
# Beta1Pow itself, and the kernel's blocks all read Beta1Pow, so it is
# never written in place. p, m, v and the velocity are updated IN PLACE.
#
# Routing is by device only: CUDA f32 tensors launch the kernel (counted
# ``static_sgd``, ``static_momentum``, ``static_adam``,
# ``static_lamb_phase1`` + ``static_lamb_apply``) or raise; CPU tensors
# take the plain version, the loop of the per-op plain versions below, so
# a run's kernel and its plain version agree bit for bit. There is no
# size floor (JAX's n < 1024 XLA route was a TPU tiling limit). Bound:
# latency at the static example's sizes (77,850 trainable parameters in
# 25 tensors, one run); device bytes for large tensors (sgd 12, momentum
# 20, adam 28 bytes an element).


def _gate(found, old, new):
    """``new``, or ``old`` where the FoundInfinite flag is set."""
    return new if found is None else torch.where(found, old, new)


def _plain_static_sgd_(p, g, lr, found):
    p.copy_(_gate(found, p, p - lr * g))


def _plain_static_momentum_(p, g, v, lr, mu, nesterov, found):
    v_new = mu * v + g
    if nesterov:
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    p.copy_(_gate(found, p, p_new))
    v.copy_(_gate(found, v, v_new))


def _static_moments(g, m, v, beta1, beta2):
    return (beta1 * m + (1 - beta1) * g,
            beta2 * v + (1 - beta2) * g * g)


def _plain_static_adam_(p, g, m, v, b1p, b2p, lr, beta1, beta2, eps, found):
    c1, c2 = b1p * beta1, b2p * beta2
    m_new, v_new = _static_moments(g, m, v, beta1, beta2)
    lr_t = lr * torch.sqrt(1 - c2) / (1 - c1)
    p_new = p - lr_t * m_new / (torch.sqrt(v_new) + eps)
    p.copy_(_gate(found, p, p_new))
    m.copy_(_gate(found, m, m_new))
    v.copy_(_gate(found, v, v_new))
    return _gate(found, b1p, c1), _gate(found, b2p, c2)


def _static_lamb_norms(p, r):
    """(|p|, |r|) as 0-dim f32 tensors on p's device, one foreach call."""
    return torch._foreach_norm([p, r])


def _plain_static_lamb_(p, g, m, v, b1p, b2p, lr, beta1, beta2, eps, wd,
                        found):
    c1, c2 = b1p * beta1, b2p * beta2
    m_new, v_new = _static_moments(g, m, v, beta1, beta2)
    r = (m_new / (1 - c1)) / (torch.sqrt(v_new / (1 - c2)) + eps) + wd * p
    w, q = _static_lamb_norms(p, r)
    trust = torch.where((w > 0) & (q > 0), w / q, torch.ones_like(w))
    p_new = p - lr * trust * r
    p.copy_(_gate(found, p, p_new))
    m.copy_(_gate(found, m, m_new))
    v.copy_(_gate(found, v, v_new))
    return _gate(found, b1p, c1), _gate(found, b2p, c2)


def _check_static(op, tensors, scalars, found):
    """Raise unless the tensors ({role: t}) are contiguous f32 of one
    shape with at least one element, the scalars ({role: t}) one-element
    f32, and ``found`` None or a one-element bool, all on p's device."""
    dev = tensors["param"].device
    shape = tuple(tensors["param"].shape)
    for role, t in tensors.items():
        if t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{op} takes contiguous f32 tensors of the "
                             f"parameter's shape {shape} on {dev}; the "
                             f"{role} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if tensors["param"].numel() == 0:
        raise ValueError(f"{op}: the parameter has no elements")
    for role, t in scalars.items():
        if t.dtype != torch.float32 or t.device != dev or t.numel() != 1:
            raise ValueError(f"{op}: {role} must be a one-element f32 "
                             f"tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if found is not None and (found.dtype != torch.bool
                              or found.device != dev or found.numel() != 1):
        raise ValueError(f"{op}: FoundInfinite must be a one-element bool "
                         f"tensor on {dev}, got {found.dtype} "
                         f"{tuple(found.shape)} on {found.device}")


def _on_cuda(op, p):
    return _device_of(op, [p]).type == "cuda"


def _plain_static_sgd_list_(params, grads, lrs, founds):
    for p, g, lr, found in zip(params, grads, lrs, founds):
        _plain_static_sgd_(p, g, lr, found)


def _plain_static_momentum_list_(params, grads, velocities, lrs, mu,
                                 nesterov, founds):
    for p, g, v, lr, found in zip(params, grads, velocities, lrs, founds):
        _plain_static_momentum_(p, g, v, lr, mu, nesterov, found)


def _plain_static_adam_list_(params, grads, m1s, m2s, b1ps, b2ps, lrs,
                             beta1, beta2, eps, founds):
    return [_plain_static_adam_(*t, beta1, beta2, eps, found)
            for *t, found in zip(params, grads, m1s, m2s, b1ps, b2ps, lrs,
                                 founds)]


def _plain_static_lamb_list_(params, grads, m1s, m2s, b1ps, b2ps, lrs,
                             beta1, beta2, eps, wd, founds):
    return [_plain_static_lamb_(*t, beta1, beta2, eps, wd, found)
            for *t, found in zip(params, grads, m1s, m2s, b1ps, b2ps, lrs,
                                 founds)]


_CAPACITY = {}


def table_splits(n_tensors: int, cap: int):
    """The consecutive launches a list of ``n_tensors`` tensors takes,
    ``cap`` at most a launch, in order: ``[(first, count), ...]``."""
    return [(a, min(cap, n_tensors - a)) for a in range(0, n_tensors, cap)]


def static_capacity(roles: int) -> int:
    """Tensors one launch whose table travels by value takes for a rule
    of ``roles`` table roles (dygraph SGD 2; static sgd 4, momentum 5,
    Lamb's apply 6, Adam and Lamb's phase 1 10): what the kernel
    parameter space of the build leaves for the table
    (``static_table_capacity``, built on first use)."""
    if roles not in _CAPACITY:
        fn = _build.entry("fused_optimizer", "static_table_capacity",
                          [ctypes.c_int])
        _CAPACITY[roles] = int(fn(roles))
        if _CAPACITY[roles] < 1:
            raise ValueError(f"no static rule has {roles} table roles")
    return _CAPACITY[roles]


def static_param_bytes() -> int:
    """The kernel parameter space the build assumed for the static
    tables: 32,764 bytes when nvcc is 12.1 or newer, else 4,096."""
    return int(_build.entry("fused_optimizer", "static_param_bytes", [])())


def _launch_args(fn_name, roles, numels, extra_types, extra, counter):
    """The rule ``fn_name``, whose table goes by value, over a list of
    tensors: ``roles`` is a list of per-role lists (tensors, or None for
    a null pointer), one entry a tensor of ``numels``. The list is cut
    into consecutive launches of at most ``static_capacity(len(roles))``
    tensors (:func:`table_splits`); each launch counts once (a part with
    no element launches nothing). Returns the launches."""
    fn = _build.entry("fused_optimizer", fn_name,
                      [_P, _P, ctypes.c_int, ctypes.c_longlong]
                      + list(extra_types) + [_P])
    dev = roles[0][0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches = 0
    for a, n in table_splits(len(numels), static_capacity(len(roles))):
        ptrs = (ctypes.c_int64 * (len(roles) * n))(
            *[0 if t is None else t.data_ptr()
              for role in roles for t in role[a:a + n]])
        ends = np.cumsum([0] + list(numels[a:a + n]))
        offs = (ctypes.c_int64 * (n + 1))(*[int(e) for e in ends])
        err = fn(ptrs, offs, n, int(ends[-1]), *extra, stream)
        _build.check("fused_optimizer", err, fn_name)
        if ends[-1]:
            counters.bump(counter)
            launches += 1
    return launches


def _run_of(op, lists, scalars, founds):
    """Check a run's per-op lists ({role: [tensor]}, all of one length,
    ``param`` among them) and scalars ({role: [tensor]}) with
    :func:`_check_static`, op by op; returns (founds as a list, whether
    the run is on the card)."""
    lists = {k: list(v) for k, v in lists.items()}
    n = len(lists["param"])
    founds = [None] * n if founds is None else list(founds)
    if n == 0:
        raise ValueError(f"{op}: an empty run")
    if any(len(v) != n for v in list(lists.values()) + [founds]) or \
            any(len(v) != n for v in scalars.values()):
        raise ValueError(f"{op}: lists of different lengths")
    dev = lists["param"][0].device
    for i in range(n):
        _check_static(op, {k: v[i] for k, v in lists.items()},
                      {k: v[i] for k, v in scalars.items()}, founds[i])
        if lists["param"][i].device != dev:
            raise ValueError(f"{op}: a run spans {dev} and "
                             f"{lists['param'][i].device}")
    return founds, _on_cuda(op, lists["param"][0])


def _pow_outputs(n, dev):
    """Op i's (1,) Beta1PowOut and Beta2PowOut: elements 2i and 2i + 1 of
    one new buffer (never the inputs, which every block reads)."""
    pows = torch.empty(2 * n, dtype=torch.float32, device=dev)
    return [(pows[2 * i:2 * i + 1], pows[2 * i + 1:2 * i + 2])
            for i in range(n)]


def static_sgd_list_(params, grads, lrs, founds=None):
    """A run of static ``sgd`` ops, IN PLACE: ``params[i] -= lrs[i] *
    grads[i]`` unless ``founds[i]`` is set. ``lrs``: each op's (1,)
    LearningRate tensor; ``founds``: None, or each op's flag or None."""
    founds, cuda = _run_of("static_sgd_", {"param": params, "grad": grads},
                           {"lr": lrs}, founds)
    if not cuda:
        _plain_static_sgd_list_(params, grads, lrs, founds)
        return
    _launch_args("static_sgd_f32", [params, grads, lrs, founds],
                 [p.numel() for p in params], (), (), "static_sgd")


def static_momentum_list_(params, grads, velocities, lrs, *, mu,
                          nesterov=False, founds=None):
    """A run of static ``momentum`` ops, IN PLACE on the parameters and
    velocities."""
    founds, cuda = _run_of("static_momentum_",
                           {"param": params, "grad": grads,
                            "velocity": velocities}, {"lr": lrs}, founds)
    if not cuda:
        _plain_static_momentum_list_(params, grads, velocities, lrs, mu,
                                     nesterov, founds)
        return
    _launch_args("static_momentum_f32",
                 [params, grads, velocities, lrs, founds],
                 [p.numel() for p in params], (_F, ctypes.c_int),
                 (float(np.float32(mu)), int(bool(nesterov))),
                 "static_momentum")


def _beta_consts(beta1, beta2, eps):
    """b1, 1-b1, b2, 1-b2, eps rounded to f32 once, as JAX rounds its
    Python constants."""
    return (float(np.float32(beta1)), float(np.float32(1.0 - beta1)),
            float(np.float32(beta2)), float(np.float32(1.0 - beta2)),
            float(np.float32(eps)))


def _adam_run(op, params, grads, m1s, m2s, b1ps, b2ps, lrs, founds):
    return _run_of(op, {"param": params, "grad": grads, "moment1": m1s,
                        "moment2": m2s},
                   {"lr": lrs, "beta1_pow": b1ps, "beta2_pow": b2ps},
                   founds)


def static_adam_list_(params, grads, m1s, m2s, b1ps, b2ps, lrs, *, beta1,
                      beta2, eps, founds=None):
    """A run of static ``adam`` ops, IN PLACE on the parameters and the
    moments; returns each op's (1,) Beta1PowOut and Beta2PowOut as new
    tensors, [(b1, b2)] in op order."""
    founds, cuda = _adam_run("static_adam_", params, grads, m1s, m2s, b1ps,
                             b2ps, lrs, founds)
    if not cuda:
        return _plain_static_adam_list_(params, grads, m1s, m2s, b1ps, b2ps,
                                        lrs, beta1, beta2, eps, founds)
    pows = _pow_outputs(len(params), params[0].device)
    _launch_args("static_adam_f32",
                 [params, grads, m1s, m2s, lrs, b1ps, b2ps, founds,
                  [a for a, _ in pows], [b for _, b in pows]],
                 [p.numel() for p in params], [_F] * 5,
                 _beta_consts(beta1, beta2, eps), "static_adam")
    return pows


def static_lamb_list_(params, grads, m1s, m2s, b1ps, b2ps, lrs, *, beta1,
                      beta2, eps, weight_decay, founds=None):
    """A run of static ``lamb`` ops, IN PLACE on the parameters and the
    moments; returns [(Beta1PowOut, Beta2PowOut)] in op order as new
    (1,) tensors. Phase 1 over the run into scratch r tensors, ONE
    ``torch._foreach_norm`` over the run's parameters and r (each
    tensor's norm on its own, as the per-op plain version takes it),
    then the update over the run."""
    founds, cuda = _adam_run("static_lamb_", params, grads, m1s, m2s, b1ps,
                             b2ps, lrs, founds)
    if not cuda:
        return _plain_static_lamb_list_(params, grads, m1s, m2s, b1ps, b2ps,
                                        lrs, beta1, beta2, eps, weight_decay,
                                        founds)
    n, numels = len(params), [p.numel() for p in params]
    rs = [torch.empty_like(p) for p in params]
    pows = _pow_outputs(n, params[0].device)
    _launch_args("static_lamb_phase1_f32",
                 [params, grads, m1s, m2s, rs, b1ps, b2ps, founds,
                  [a for a, _ in pows], [b for _, b in pows]], numels,
                 [_F] * 6, _beta_consts(beta1, beta2, eps)
                 + (float(np.float32(weight_decay)),),
                 "static_lamb_phase1")
    norms = torch._foreach_norm(list(params) + rs)
    _launch_args("static_lamb_apply_f32",
                 [params, rs, lrs, norms[:n], norms[n:], founds], numels,
                 (), (), "static_lamb_apply")
    return pows


def static_sgd_(param, grad, lr, found=None):
    """The static ``sgd`` op, IN PLACE: ``param -= lr*grad`` unless
    ``found`` is set. ``lr``: the (1,) LearningRate tensor. A run of
    one: :func:`static_sgd_list_`."""
    static_sgd_list_([param], [grad], [lr], [found])


def static_momentum_(param, grad, velocity, lr, *, mu, nesterov=False,
                     found=None):
    """The static ``momentum`` op, IN PLACE on ``param`` and
    ``velocity``."""
    static_momentum_list_([param], [grad], [velocity], [lr], mu=mu,
                          nesterov=nesterov, founds=[found])


def static_adam_(param, grad, moment1, moment2, beta1_pow, beta2_pow, lr, *,
                 beta1, beta2, eps, found=None):
    """The static ``adam`` op, IN PLACE on ``param`` and the moments;
    returns the (1,) Beta1PowOut and Beta2PowOut as new tensors."""
    return static_adam_list_([param], [grad], [moment1], [moment2],
                             [beta1_pow], [beta2_pow], [lr], beta1=beta1,
                             beta2=beta2, eps=eps, founds=[found])[0]


def static_lamb_(param, grad, moment1, moment2, beta1_pow, beta2_pow, lr, *,
                 beta1, beta2, eps, weight_decay, found=None):
    """The static ``lamb`` op, IN PLACE on ``param`` and the moments;
    returns the (1,) Beta1PowOut and Beta2PowOut as new tensors. Two
    launches (phase 1 into a scratch r, then the update) around one
    ``torch._foreach_norm``."""
    return static_lamb_list_([param], [grad], [moment1], [moment2],
                             [beta1_pow], [beta2_pow], [lr], beta1=beta1,
                             beta2=beta2, eps=eps, weight_decay=weight_decay,
                             founds=[found])[0]


# ---------------------------------------------------------------------------
# K3's ZeRO chunk entry (``fused_chunk_update``, ``paddle_tpu/ops/pallas/
# fused_optimizer.py:455``): one ZeRO bucket's update on this rank's flat
# (c,) chunk of the bucket's padded concatenation. sgd, momentum and adam
# are elementwise, so they are the static forms above on the chunk. Lamb's
# trust ratio needs each parameter's global norms, of which the rank holds
# a part, so it runs in two phases around a cross-rank sum:
#
#     1. kernel:  m2, v2, r as the static Lamb (r into a scratch), and the
#                 partial sums of p*p and r*r of each PIECE of the chunk: a
#                 run of at most chunk_piece(c) elements inside one segment
#                 (element j of parameter i is segment i, the padding the
#                 sentinel segment n_params); one block a piece, float4
#                 loads, a fixed reduction tree; the block that finishes
#                 last (an integer ticket, no float atomics) adds each
#                 segment's pieces in a fixed order, in f64, into the
#                 (n_params + 1, 2) f32 buffer (the plain version sums the
#                 f32 squares in f64 too)
#     2. PyTorch: that buffer summed over the dp axis (collectives.all_reduce,
#                 JAX's psum at :522-523)
#     3. kernel:  trust = |p|/|r| of the piece's segment where both > 0,
#                 else 1;  p2 = p - (lr*trust)*r
#
# so two runs give the same bits. The piece table depends only on the
# bucket's parameter sizes and the rank's position: it is built once on
# the host and kept in the caller's ``cache`` with the piece-sum scratch
# and the ticket (an int32 that the last block of each launch sets back
# to 0). A set FoundInfinite keeps p, m, v and the beta-pows, which are
# returned as new (1,) tensors as in the static forms. Counted
# ``chunk_lamb_phase1`` and ``chunk_lamb_apply``, one launch each. Bound:
# bytes. The function reads p, g, m, v and writes p, m, v: 28 bytes an
# element once (the launches move 40: phase 1 reads p, g, m, v and writes
# m, v, r; the apply reads p, r and writes p). JAX's norms sum in another
# order (XLA's segment_sum, and the psum across ranks re-associates them),
# so against JAX or the unsharded Lamb the update holds to a tolerance; m
# and v are the static form's bit for bit.
# ---------------------------------------------------------------------------
CHUNK_PIECE = 8192     # the largest piece: a block streams 8 float4 a thread
CHUNK_SPREAD = 264     # pieces a small chunk aims at: 2 for each of 132 SMs


def chunk_piece(c: int) -> int:
    """Elements a piece of a ``c``-element chunk holds at most: the
    least power of two from 512 to :data:`CHUNK_PIECE` that cuts the
    chunk into at most :data:`CHUNK_SPREAD` runs (the book net's 9,216
    elements: 512; 524,288: 2048; BERT-base's word-embedding chunk:
    8192)."""
    piece = 512
    while piece < CHUNK_PIECE and piece * CHUNK_SPREAD < int(c):
        piece *= 2
    return piece


def chunk_segments(param_elems, position: int, c: int) -> np.ndarray:
    """(c,) int64: the segment of each element of the chunk at flat
    ``position`` of a bucket holding parameters of ``param_elems``
    elements (``searchsorted(ends, position + arange(c), "right")``, as
    ``_chunk_segments`` computes it)."""
    ends = np.cumsum(np.asarray(param_elems, np.int64))
    return np.searchsorted(ends, int(position) + np.arange(c, dtype=np.int64),
                           side="right")


def chunk_pieces(param_elems, position: int, c: int, piece: int = None):
    """The chunk cut at segment ends and every ``piece`` elements
    (default :func:`chunk_piece` of ``c``): ``(pieces, seg_first)``,
    ``pieces`` (n, 3) int64 rows (start, length, segment) in chunk order,
    ``seg_first`` (n_params + 2,) int64 with segment s's pieces at rows
    ``seg_first[s]:seg_first[s + 1]``."""
    if piece is None:
        piece = chunk_piece(c)
    ends = np.cumsum(np.asarray(param_elems, np.int64))
    cuts = sorted({0, int(c)} | {int(e) - int(position) for e in ends
                                 if 0 < int(e) - int(position) < c})
    rows = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        seg = int(np.searchsorted(ends, int(position) + a, side="right"))
        rows += [(s, min(piece, b - s), seg) for s in range(a, b, piece)]
    pieces = np.asarray(rows, np.int64).reshape(-1, 3)
    seg_first = np.searchsorted(pieces[:, 2], np.arange(len(ends) + 2),
                                side="left").astype(np.int64)
    return pieces, seg_first


def _plain_chunk_lamb_(p, g, m, v, b1p, b2p, lr, beta1, beta2, eps, wd,
                       found, seg, n_seg, reduce):
    """The chunk Lamb in PyTorch: ``seg`` the (c,) segment ids on p's
    device, ``reduce`` sums the (n_seg, 2) buffer of p*p and r*r across
    ranks in place (or does nothing)."""
    c1, c2 = b1p * beta1, b2p * beta2
    m_new, v_new = _static_moments(g, m, v, beta1, beta2)
    r = (m_new / (1 - c1)) / (torch.sqrt(v_new / (1 - c2)) + eps) + wd * p
    # f32 squares summed in f64, as the kernels sum their pieces
    f64 = torch.float64
    sq = torch.stack([
        p.new_zeros(n_seg, dtype=f64).index_add_(0, seg, (p * p).to(f64)),
        p.new_zeros(n_seg, dtype=f64).index_add_(0, seg, (r * r).to(f64))],
        1).to(torch.float32)
    reduce(sq)
    w, q = torch.sqrt(sq).unbind(1)
    trust = torch.where((w > 0) & (q > 0),
                        w / torch.where(q > 0, q, torch.ones_like(q)),
                        torch.ones_like(w))
    p_new = p - (lr * trust[seg]) * r
    p.copy_(_gate(found, p, p_new))
    m.copy_(_gate(found, m, m_new))
    v.copy_(_gate(found, v, v_new))
    return _gate(found, b1p, c1), _gate(found, b2p, c2)


def _chunk_tables(param_elems, position, c, dev, cache):
    """The piece table, segment offsets, piece-sum scratch and ticket on
    ``dev``, made once per (parameter sizes, position, chunk) and kept in
    ``cache``."""
    key = (tuple(int(e) for e in param_elems), int(position), int(c), dev)
    if cache.get("key") != key:
        pieces, seg_first = chunk_pieces(param_elems, position, c)
        cache["key"] = key
        cache["pieces"] = torch.from_numpy(pieces).pin_memory().to(
            dev, non_blocking=True)
        cache["seg_first"] = torch.from_numpy(seg_first).pin_memory().to(
            dev, non_blocking=True)
        cache["piece_sums"] = torch.empty(len(pieces), 2,
                                          dtype=torch.float32, device=dev)
        cache["ticket"] = torch.zeros(1, dtype=torch.int32, device=dev)
    return (cache["pieces"], cache["seg_first"], cache["piece_sums"],
            cache["ticket"])


def _cuda_chunk_lamb_(p, g, m, v, b1p, b2p, lr, beta1, beta2, eps, wd,
                      found, param_elems, position, reduce, cache):
    dev = p.device
    pieces, seg_first, piece_sums, ticket = _chunk_tables(
        param_elems, position, p.numel(), dev, cache)
    n_pieces, n_seg = pieces.shape[0], seg_first.shape[0] - 1
    r = torch.empty_like(p)
    seg_sums = torch.empty(n_seg, 2, dtype=torch.float32, device=dev)
    pows = torch.empty(2, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = _build.entry("fused_optimizer", "chunk_lamb_phase1_f32",
                      [_P] * 10 + [_P, ctypes.c_int, _P, ctypes.c_int, _P,
                                   _P, _P] + [_F] * 6 + [_P])
    flag = 0 if found is None else found.data_ptr()
    err = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
             r.data_ptr(), b1p.data_ptr(), b2p.data_ptr(), flag,
             pows[0:1].data_ptr(), pows[1:2].data_ptr(), pieces.data_ptr(),
             n_pieces, seg_first.data_ptr(), n_seg, piece_sums.data_ptr(),
             seg_sums.data_ptr(), ticket.data_ptr(),
             *_beta_consts(beta1, beta2, eps), float(np.float32(wd)),
             stream)
    _build.check("fused_optimizer", err, "chunk_lamb_phase1_f32")
    counters.bump("chunk_lamb_phase1")
    reduce(seg_sums)
    fn = _build.entry("fused_optimizer", "chunk_lamb_apply_f32",
                      [_P] * 5 + [ctypes.c_int, _P, _P])
    err = fn(p.data_ptr(), r.data_ptr(), lr.data_ptr(), flag,
             pieces.data_ptr(), n_pieces, seg_sums.data_ptr(), stream)
    _build.check("fused_optimizer", err, "chunk_lamb_apply_f32")
    counters.bump("chunk_lamb_apply")
    return pows[0:1], pows[1:2]


def chunk_lamb_(param, grad, moment1, moment2, beta1_pow, beta2_pow, lr, *,
                beta1, beta2, eps, weight_decay, param_elems, position,
                found=None, mesh=None, axis=None, cache=None):
    """Lamb on one flat ZeRO chunk, IN PLACE on ``param`` and the
    moments; returns the (1,) Beta1PowOut and Beta2PowOut as new
    tensors. ``param_elems``: the bucket's parameter sizes;
    ``position``: the chunk's flat offset in the bucket; ``axis``: the
    mesh axis whose ranks hold the bucket's other chunks (None: this
    chunk is the whole bucket)."""
    _check_static("chunk_lamb_", {"param": param, "grad": grad,
                                  "moment1": moment1, "moment2": moment2},
                  {"lr": lr, "beta1_pow": beta1_pow,
                   "beta2_pow": beta2_pow}, found)
    if param.dim() != 1:
        raise ValueError(f"chunk_lamb_ takes a flat chunk, got shape "
                         f"{tuple(param.shape)}")

    def reduce(t):
        if axis is not None:
            from ...parallel import collectives

            collectives.all_reduce(t, [axis], mesh)

    args = (param, grad, moment1, moment2, beta1_pow, beta2_pow, lr, beta1,
            beta2, eps, weight_decay, found)
    if not _on_cuda("chunk_lamb_", param):
        seg = torch.from_numpy(chunk_segments(param_elems, position,
                                              param.numel()))
        return _plain_chunk_lamb_(*args, seg, len(param_elems) + 1, reduce)
    return _cuda_chunk_lamb_(*args, param_elems, position, reduce,
                             {} if cache is None else cache)


def chunk_update(op_type, ins, attrs, *, mesh=None, axis=None,
                 param_elems=None, position=0, cache=None):
    """One ZeRO bucket's update on this rank's (c,) chunk, the static
    op's ``(ins, attrs) -> outs`` slots (``fused_chunk_update``):
    sgd, momentum and adam are their static forms; lamb is
    :func:`chunk_lamb_`. The chunk tensors are updated in place and
    returned in the out slots."""
    if op_type not in ("sgd", "momentum", "adam", "lamb"):
        raise NotImplementedError(f"no chunk update for {op_type!r}")
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0]
    found = ins["FoundInfinite"][0] if ins.get("FoundInfinite") else None
    if op_type == "sgd":
        static_sgd_(p, g, lr, found)
        return {"ParamOut": [p]}
    if op_type == "momentum":
        v = ins["Velocity"][0]
        static_momentum_(p, g, v, lr, mu=attrs.get("mu", 0.9),
                         nesterov=attrs.get("use_nesterov", False),
                         found=found)
        return {"ParamOut": [p], "VelocityOut": [v]}
    m, v = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    beta = dict(beta1=attrs.get("beta1", 0.9),
                beta2=attrs.get("beta2", 0.999))
    if op_type == "adam":
        pows = static_adam_(p, g, m, v, b1p, b2p, lr,
                            eps=attrs.get("epsilon", 1e-8), found=found,
                            **beta)
    else:
        pows = chunk_lamb_(p, g, m, v, b1p, b2p, lr,
                           eps=attrs.get("epsilon", 1e-6),
                           weight_decay=attrs.get("weight_decay", 0.01),
                           param_elems=param_elems, position=position,
                           found=found, mesh=mesh, axis=axis, cache=cache,
                           **beta)
    return {"ParamOut": [p], "Moment1Out": [m], "Moment2Out": [v],
            "Beta1PowOut": [pows[0]], "Beta2PowOut": [pows[1]]}
