"""``CompiledProgram``: data-parallel execution of a Program (port of
``paddle_tpu/static/compiler.py``).

``BuildStrategy`` has every field and default of the JAX package's
(``compiler.py:142-169``). In this slice ``mesh_shape = {"dp": g}``
trains data-parallel over g ranks (one process each; every rank runs
``Executor.run`` on the global batch and takes its own rows), with
``comm_quant`` / ``comm_bucket_bytes`` / ``comm_error_feedback`` (the
explicit bucketed quantized ring) and ``zero_stage`` 2 or 3 (sharded
optimizer states); see ``static/stepplan.py``. Set away from their
defaults, ``amp``, ``recompute``, ``gradient_merge_k > 1``,
``pipeline_stages > 1`` and ``sharding_hints`` raise
``NotImplementedError`` when the program runs. The descriptive knobs
(``fuse_*``, ``memory_optimize``, ``enable_inplace``,
``constant_folding``, ``cse``, ``reduce_strategy``) are accepted and
have no effect: the port has no IR pass pipeline yet.
"""
from __future__ import annotations

from typing import Optional

from .ir import Program

__all__ = ["BuildStrategy", "ExecutionStrategy", "CompiledProgram",
           "check_strategy"]


class BuildStrategy:
    """The JAX package's knobs (reference ``details/build_strategy.h``):
    see ``paddle_tpu/static/compiler.py`` for what each does there."""

    def __init__(self):
        self.reduce_strategy = "AllReduce"
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.memory_optimize = True
        self.enable_inplace = True
        self.constant_folding = True
        self.cse = True
        self.amp = False
        self.amp_dtype = "bfloat16"
        self.amp_level = "O1"
        self.amp_init_loss_scale = 2.0 ** 15
        self.recompute = False
        self.recompute_checkpoints = ()
        self.recompute_segments = 0
        self.gradient_merge_k = 1
        self.gradient_merge_avg = True
        self.mesh_shape = {}
        self.sharding_hints = {}
        self.pipeline_stages = 1
        self.pipeline_schedule = "gpipe"
        self.pipeline_interleave = 2
        self.zero_stage = 0
        self.comm_quant = "off"
        self.comm_bucket_bytes = 4 << 20
        self.comm_error_feedback = False
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 10


_LATER = (("amp", lambda v: bool(v), "static AMP"),
          ("recompute", lambda v: bool(v), "recompute"),
          ("gradient_merge_k", lambda v: int(v or 1) > 1,
           "gradient merge (gradient_merge_k > 1)"),
          ("pipeline_stages", lambda v: int(v or 1) > 1,
           "the pipeline schedules (pipeline_stages > 1)"),
          ("sharding_hints", lambda v: bool(v),
           "tensor-parallel sharding_hints"))


def check_strategy(strategy: BuildStrategy) -> None:
    """Raise ``NotImplementedError`` for a knob this slice leaves out."""
    for field, is_set, what in _LATER:
        if is_set(getattr(strategy, field, None)):
            raise NotImplementedError(
                f"BuildStrategy.{field}: {what} is not in this port "
                "slice; a later port slice adds it")


class CompiledProgram:
    """A Program with a ``BuildStrategy``; ``Executor.run`` takes it."""

    def __init__(self, program_or_graph: Program,
                 build_strategy: Optional[BuildStrategy] = None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = ExecutionStrategy()
        self._data_parallel = False
        self._loss_name = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, places=None):
        """Train data-parallel. Without ``mesh_shape`` the JAX package
        lays a "data" axis over every device; the port's ranks are
        processes, so the mesh must be named: set
        ``build_strategy.mesh_shape = {"dp": g}`` (``places`` is taken
        for the signature)."""
        self._data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        if exec_strategy is not None:
            self._exec_strategy = exec_strategy
        return self
