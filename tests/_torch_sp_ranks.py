"""Rank bodies of the port's multi-process tests (tests/test_torch_ring.py,
tests/test_torch_gpt.py, tests/test_torch_cuda.py), at module level so
that ``paddle_tpu_torch.distributed.spawn`` can import them in each rank.
They import torch and the port only: a rank never loads JAX.

Each body joins a gloo group (``init_parallel_env("gloo")``), runs one
thread (``torch.set_num_threads(1)``), and returns numpy arrays.
"""
import numpy as np
import torch

from paddle_tpu_torch.distributed import init_parallel_env
from paddle_tpu_torch.ops.cuda import counters


def _np(t):
    return t.detach().float().cpu().numpy()


def ring_rank(n, cases, device="cpu"):
    """``ring_attention`` on ``create_mesh({"sp": n})`` for each case
    (name, q, k, v, w, is_causal, lens or None): the global output and
    the gradients of sum(w * out) in q, k and v, and the launches."""
    from paddle_tpu_torch.parallel import create_mesh, ring_attention

    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    init_parallel_env("gloo")
    mesh = create_mesh({"sp": n})
    got = {}
    counters.reset()
    for name, q, k, v, w, causal, lens in cases:
        q, k, v = (torch.tensor(x, device=device, requires_grad=True)
                   for x in (q, k, v))
        mask = None if lens is None else \
            torch.arange(q.shape[1], device=device)[None, :] \
            < torch.tensor(lens, device=device)[:, None]
        out = ring_attention(q, k, v, mesh=mesh, is_causal=causal,
                             kv_mask=mask)
        (out * torch.tensor(w, device=device)).sum().backward()
        got[name] = [_np(x) for x in (out, q.grad, k.grad, v.grad)]
    got["launches"] = counters.snapshot()
    return got


def _gpt(cfg, state, device):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM, load_numpy_state

    model = GPTForCausalLM(cfg, device=device)
    load_numpy_state(model, state)
    return model


def gpt_sp_rank(mesh_shape, cfg, state, ids, steps, lr, device="cpu"):
    """``steps`` AdamW steps of a GPT through ``TrainStep(mesh=...,
    data_spec=PartitionSpec("dp", "sp"), sequence_parallel="sp")`` on the
    global batch ``ids``: losses, every parameter after the steps, the
    step-1 all-reduced gradients, this rank's kernel launches and the
    attention-dropout check (NotImplementedError under the ring)."""
    import dataclasses

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import (PartitionSpec, create_mesh,
                                           sequence_parallel)

    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    init_parallel_env("gloo")
    mesh = create_mesh(mesh_shape)
    model = _gpt(cfg, state, device)
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                weight_decay=0.01)
    step = TrainStep(model, lambda m, x: m.loss(x), opt, mesh=mesh,
                     data_spec=PartitionSpec("dp", "sp"),
                     sequence_parallel="sp")
    batch = torch.tensor(ids, device=device)
    counters.reset()
    losses, grads = [], None
    for i in range(steps):
        losses.append(float(step(batch)))
        if i == 0:
            grads = {n: _np(p.grad) for n, p in model.named_parameters()}
    launches = counters.snapshot()
    drop = _gpt(dataclasses.replace(cfg, attention_probs_dropout_prob=0.1),
                state, device)
    local = step._local(batch)
    try:
        with sequence_parallel("sp", mesh=mesh):
            drop.loss(local)
        dropout_raises = False
    except NotImplementedError:
        dropout_raises = True
    return {"losses": losses, "grads": grads, "launches": launches,
            "params": {n: _np(p) for n, p in model.named_parameters()},
            "coords": mesh.coords, "dropout_raises": dropout_raises}
