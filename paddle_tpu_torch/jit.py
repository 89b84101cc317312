"""``TrainStep``: forward, backward and optimizer update in one call.

Port of ``paddle_tpu/jit.py`` ``TrainStep`` (``:180-290``). The JAX step
is one compiled XLA program; here each call runs the three phases
eagerly on the model's device (CUDA launches are asynchronous, so
nothing waits for the card unless the caller reads the loss). The model
is kept in train mode. Dropout draws from a
:class:`framework.random.StepRNG` seeded by ``fold_in(seed, step)``,
the counterpart of ``jax.random.fold_in(make_key(seed), step)``
(``jit.py:300``), with ``step`` the optimizer's step count before the
update (0 on the first call). Its bits differ from JAX's. No
``torch.compile``. The optimizer keeps its state across calls, so a
model and optimizer decorated by ``amp.decorate(level="O2")`` train on
their f32 masters (the step takes them as JAX's ``init_state(params,
param_objs)`` takes restored slots), and the returned loss keeps the
dtype the loss function gives it (bf16 for BERT at O2).

With a ``mesh`` (``parallel.create_mesh``; one process per rank, every
rank calling the step with the same global batch) the step is the
multi-process form of JAX's SPMD step:

- each rank takes its slice of every batch tensor by ``data_spec``
  (a ``PartitionSpec`` of mesh axes per dimension; default: dim 0 over
  the ``data_axes`` the mesh has) and its coordinates on those axes;
- with ``sequence_parallel`` (an axis name, or ``(axis, impl)``) the
  step runs inside ``parallel.sequence_parallel(axis, mesh=mesh)``, so
  attention is ring attention and models take their sequence shard;
- after the backward the gradients are summed over every axis the batch
  is sharded on (flat buckets, ``collectives.all_reduce_grads``) and
  divided by the product of those axes' sizes other than the
  sequence-parallel one: the data-parallel replicas' mean, which is
  JAX's mean over the global batch (a sequence-parallel loss is already
  the mean over its whole sequence, its gradient split over the ranks);
- the returned loss is averaged over those data-parallel axes too;
- the dropout stream folds in the rank, so ranks draw different masks.

Tensor-parallel ``param_rules`` (slice 11b) and ``zero_stage`` (slice
9) raise ``NotImplementedError``; ``zero_axis`` is kept for the JAX
signature and has no effect until ``zero_stage`` is ported.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import numpy as np
import torch

from .framework.random import StepRNG, fold_in, rng_scope
from .parallel import collectives
from .parallel.ring import sequence_parallel as _sp_scope

__all__ = ["TrainStep"]


class TrainStep:
    """``loss_fn(model, *batch)`` returns a scalar loss; each call
    trains one step and returns the detached loss."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 seed: int = 0, mesh=None, param_rules=None,
                 data_axes=("dp", "data"), data_spec=None,
                 sequence_parallel=None, zero_stage=0, zero_axis="dp"):
        if param_rules is not None:
            raise NotImplementedError("TrainStep(param_rules=...): tensor "
                                      "parallelism is port slice 11b")
        if zero_stage:
            raise NotImplementedError("TrainStep(zero_stage=...): ZeRO is "
                                      "port slice 9")
        if isinstance(sequence_parallel, str):
            sequence_parallel = (sequence_parallel, "ring")
        if sequence_parallel is not None and mesh is None:
            raise ValueError("TrainStep(sequence_parallel=...) needs a mesh")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._seed = int(seed)
        self._mesh = mesh
        self._sequence_parallel = sequence_parallel
        self._spec = None
        if mesh is not None:
            spec = data_spec if data_spec is not None else \
                (tuple(a for a in data_axes if a in mesh.axis_names),)
            self._spec = tuple(
                tuple(a for a in _axes(e) if mesh.axis_size(a) > 1)
                for e in spec)
            self._row_axes = [a for e in self._spec for a in e]
            sp = sequence_parallel[0] if sequence_parallel else None
            self._dp_axes = [a for a in self._row_axes if a != sp]
            self._dp = int(np.prod([mesh.axis_size(a)
                                    for a in self._dp_axes]))

    def _local(self, x):
        """This rank's slice of a batch tensor by the data spec."""
        if not torch.is_tensor(x):
            return x
        mesh = self._mesh
        for dim, axes in enumerate(self._spec[:x.dim()]):
            if not axes:
                continue
            n, idx = 1, 0
            for a in axes:          # row-major over the listed axes
                n, idx = n * mesh.axis_size(a), \
                    idx * mesh.axis_size(a) + mesh.axis_index(a)
            if x.shape[dim] % n:
                raise ValueError(f"batch dim {dim} of {tuple(x.shape)} is "
                                 f"not divisible by {axes} = {n}")
            size = x.shape[dim] // n
            x = x.narrow(dim, idx * size, size)
        return x

    def __call__(self, *batch):
        model = self.model
        model.train()
        mesh = self._mesh
        device = next(model.parameters()).device
        seed = fold_in(self._seed, self.optimizer._step_count)
        scope = contextlib.nullcontext()
        if mesh is not None:
            seed = fold_in(seed, mesh.rank)
            batch = tuple(self._local(x) for x in batch)
            if self._sequence_parallel is not None:
                axis, impl = self._sequence_parallel
                scope = _sp_scope(axis, impl, mesh=mesh)
        rng = StepRNG(seed, device)
        self.optimizer.clear_grad()
        with rng_scope(rng), scope:
            loss = self.loss_fn(model, *batch)
            loss.backward()
        if mesh is not None:
            collectives.all_reduce_grads(model.parameters(), self._row_axes,
                                         mesh, divide=self._dp)
        self.optimizer.step()
        loss = loss.detach()
        if mesh is not None and self._dp > 1:
            loss = collectives.all_reduce(loss.clone(), self._dp_axes,
                                          mesh) / self._dp
        return loss


def _axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
