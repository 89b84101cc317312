"""append_backward: reverse-mode autodiff for static programs.

Port of ``paddle_tpu/static/backward.py``'s ``append_backward``: one
``backward`` OpDesc marks the boundary between the forward ops and the
update ops, with the loss and the trainable parameters as inputs and
``name@GRAD`` variables as outputs, so the optimizer ops are wired as in
the JAX package.

The JAX package lowers that op by re-tracing the forward ops under
``jax.vjp``. The port's executor interprets the block once, op by op
(``executor.run_block``): it binds each parameter of the op as a fresh
autograd leaf before the forward ops, and :func:`run_backward_op` pulls
every gradient from the recorded graph with one
``torch.autograd.grad``. A parameter with no path to the loss gets
zeros, as ``jax.vjp`` gives.

Not in this slice: ``checkpoints`` (recompute) and ``calc_gradient``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Set

import torch

from .ir import ParamDesc, Variable, grad_var_name

__all__ = ["append_backward", "BACKWARD_OP_TYPES"]

BACKWARD_OP_TYPES = {"backward"}


def append_backward(loss: Variable,
                    parameter_list: Optional[Sequence] = None,
                    no_grad_set: Optional[Set[str]] = None,
                    checkpoints: Optional[Sequence] = None):
    """Append the backward op; returns [(param, grad_var), ...]."""
    if checkpoints:
        raise NotImplementedError(
            "append_backward(checkpoints=...) (recompute) is not in this "
            "port slice; a later port slice adds it")
    block = loss.block
    no_grad = {n if isinstance(n, str) else n.name
               for n in (no_grad_set or ())}
    if parameter_list is not None:
        params = [p if isinstance(p, str) else p.name
                  for p in parameter_list]
    else:
        params = [v.name for v in block.vars.values()
                  if isinstance(v, ParamDesc) and v.trainable]
    params = [p for p in params if p not in no_grad]
    if not params:
        raise ValueError("append_backward: no trainable parameters found")

    grad_names = []
    for p in params:
        pdesc = block.vars[p]
        gname = grad_var_name(p)
        block.create_var(name=gname, shape=pdesc.shape, dtype=pdesc.dtype,
                         stop_gradient=True)
        grad_names.append(gname)

    block.append_op(
        type="backward",
        inputs={"Loss": [loss.name], "Params": params},
        outputs={"Grads": grad_names},
        attrs={"use_checkpoint": False, "checkpoints": []},
    )
    return [(block.var(p), block.var(g)) for p, g in zip(params, grad_names)]


def run_backward_op(op, env: Dict[str, torch.Tensor]) -> None:
    """The ``backward`` op: d loss / d param for each param of the op,
    into the op's grad variables. ``env`` holds the loss and, for each
    param, the leaf the forward ops ran on."""
    loss = env[op.inputs["Loss"][0]]
    leaves = [env[p] for p in op.inputs["Params"]]
    if not loss.requires_grad:
        grads = [None] * len(leaves)
    else:
        grads = torch.autograd.grad(loss, leaves, torch.ones_like(loss),
                                    allow_unused=True)
    for gname, leaf, g in zip(op.outputs["Grads"], leaves, grads):
        env[gname] = torch.zeros_like(leaf) if g is None else g
