"""Gradient clipping (port of ``paddle_tpu/nn/clip.py``):
``ClipGradByValue``, ``ClipGradByNorm``, ``ClipGradByGlobalNorm``, their
``GradientClipBy*`` aliases and ``clip_grad_norm_``.

Each clip maps a list of gradients to a list (``apply_pytree``, the
form the optimizers call before the update, as
``apply_gradients_fn`` does), or ``[(param, grad)]`` pairs to pairs
(``__call__``). Everything stays on the gradients' device: the norms
are ``torch._foreach_norm`` and the scales 0-dim device tensors, so a
clip costs no ``.item()`` and no host sync. The JAX package computes
these reductions in XLA, outside any Pallas kernel, so PyTorch ops are
their port. ``ErrorClipByValue`` and ``set_gradient_clip`` belong to
the static graph, a later slice.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "GradientClipByValue",
           "GradientClipByNorm", "GradientClipByGlobalNorm",
           "clip_grad_norm_"]


class ClipGradBase:
    def __call__(self, params_grads):
        grads = self.apply_pytree([g for _, g in params_grads])
        return [(p, g) for (p, _), g in zip(params_grads, grads)]

    def apply_pytree(self, grads):
        """The clipped gradients, as a new list of new tensors."""
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def apply_pytree(self, grads):
        return [g.clamp(self.min, self.max) for g in grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to at most ``clip_norm`` on its own:
    ``g * min(clip_norm / max(|g|, 1e-12), 1)``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def apply_pytree(self, grads):
        grads = list(grads)
        if not grads:
            return []
        norms = torch._foreach_norm(grads)
        return [g * _over(self.clip_norm, n.clamp(min=1e-12)).clamp(max=1.0)
                for g, n in zip(grads, norms)]


def _over(c, x):
    """``c / x`` for a Python float ``c``, divided as JAX does (``c / x``
    alone is a reciprocal multiply in PyTorch, one rounding more)."""
    return torch.full_like(x, c) / x


def _global_scale(grads, clip_norm):
    """(0-dim global norm, 0-dim ``clip_norm / max(norm, clip_norm)``),
    both on the gradients' device. Gradients all of one 2-byte type take
    JAX's roundings in that type (``sqrt(sum_t sum(square(g_t)))``: each
    square, each tensor's sum and each partial total rounded to it); the
    norms of other lists are f32 sums of ``_foreach_norm``'s squares."""
    if len({g.dtype for g in grads}) == 1 and \
            grads[0].dtype in (torch.bfloat16, torch.float16):
        total = None
        for g in grads:
            s = torch.sum(g * g)
            total = s if total is None else total + s
        gnorm = torch.sqrt(total)
    else:
        gnorm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
    return gnorm, _over(clip_norm, gnorm.clamp(min=clip_norm))


class ClipGradByGlobalNorm(ClipGradBase):
    """All gradients scaled by one factor so that their joint norm is at
    most ``clip_norm``: ``clip_norm / max(global_norm, clip_norm)``."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def apply_pytree(self, grads):
        grads = list(grads)
        if not grads:
            return []
        _, scale = _global_scale(grads, self.clip_norm)
        return torch._foreach_mul(grads, scale)


# reference-name aliases
GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm


def clip_grad_norm_(parameters, max_norm):
    """Scale every ``.grad`` IN PLACE so that their joint norm is at most
    ``max_norm``; returns the norm before clipping as a 0-dim tensor on
    the gradients' device (the JAX function returns a float: reading
    this one on the host is the caller's choice)."""
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    gnorm, scale = _global_scale(grads, float(max_norm))
    torch._foreach_mul_(grads, scale)
    return gnorm
