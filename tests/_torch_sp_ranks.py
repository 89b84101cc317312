"""Rank bodies of the port's multi-process tests (tests/test_torch_ring.py,
tests/test_torch_gpt.py, tests/test_torch_sp_fp16.py,
tests/test_torch_cuda.py), at module level so
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


def _join(device):
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
    init_parallel_env("gloo")


def ring_rank(n, cases, device="cpu"):
    """``ring_attention`` on ``create_mesh({"sp": n})`` for each case
    (name, q, k, v, w, is_causal, lens or None): the global output and
    the gradients of sum(w * out) in q, k and v, and the launches."""
    _join(device)
    return _ring_cases(n, cases, device)


def _ring_cases(n, cases, device):
    from paddle_tpu_torch.parallel import create_mesh, ring_attention

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
    _join(device)
    return _gpt_steps(mesh_shape, cfg, state, ids, steps, lr, device)


def o1_fp16_loss(m, x):
    """The GPT's loss under AMP O1 fp16."""
    from paddle_tpu_torch import amp

    with amp.auto_cast(level="O1", dtype="float16"):
        return m.loss(x)


def sp_fp16_rank(ring_cases, cfg, state, ids, steps, lr):
    """The SP checks at f16 in one gloo group of 4 ranks on the CPU:
    ``ring_attention`` over ``create_mesh({"sp": 4})`` for each f16 case
    (as ``ring_rank``), then ``steps`` AdamW steps of a GPT at AMP O1
    fp16 over ``create_mesh({"dp": 2, "sp": 2})`` (as ``gpt_sp_rank``):
    {"ring": ..., "gpt": ...}."""
    _join("cpu")
    return {"ring": _ring_cases(4, ring_cases, "cpu"),
            "gpt": _gpt_steps({"dp": 2, "sp": 2}, cfg, state, ids, steps,
                              lr, "cpu", o1_fp16_loss)}


def _gpt_steps(mesh_shape, cfg, state, ids, steps, lr, device,
               loss_fn=None):
    import dataclasses

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import (PartitionSpec, create_mesh,
                                           sequence_parallel)

    mesh = create_mesh(mesh_shape)
    model = _gpt(cfg, state, device)
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                weight_decay=0.01)
    step = TrainStep(model, loss_fn or (lambda m, x: m.loss(x)), opt,
                     mesh=mesh, data_spec=PartitionSpec("dp", "sp"),
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
