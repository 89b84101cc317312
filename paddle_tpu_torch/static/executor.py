"""Static-graph Executor + Scope.

Port of ``paddle_tpu/static/executor.py``'s ``Scope``, ``global_scope``,
``scope_guard``, ``run_block`` and ``Executor`` (``run``,
``run_startup``). The JAX package lowers a whole block to one jitted
XLA program. The port interprets the block op by op on the card, as the
reference's C++ executor does: ``run_block`` walks the ops over an env
dict of tensors, each op's kernel (``kernels.py``) running eagerly; a
run of consecutive optimizer updates of one type (``op_runs``) goes to
one group kernel, so a step's updates are one launch, not one an op.

- Before a ``backward`` op, each parameter it names is bound as a fresh
  autograd leaf (``detach().requires_grad_()``) and the forward ops run
  with grad recording on; the backward op pulls every gradient with one
  ``torch.autograd.grad`` (``backward.run_backward_op``); the ops after
  it (the updates) run under ``torch.no_grad()`` and may update a
  parameter in place.
- A run executes the ops its fetches and the persistables need
  (``live_ops``, the JAX package's dead-code rule, computed once per
  program version and fetch list).
- Persistable state lives in the Scope as tensors on the executor's
  device; feeds go to the device once a step; fetches come back as numpy
  (``return_numpy``) or tensors.

``run`` also takes a ``CompiledProgram`` (``compiler.py``) whose
``BuildStrategy.mesh_shape`` is ``{"dp": g}``: one rank of a
data-parallel step over ``parallel.create_mesh({"dp": g})``, with the
explicit quantized ring (``comm_quant``) and ZeRO-2/3 (``zero_stage``);
``stepplan.py`` holds the plan kinds. ``Executor.counters`` has the JAX
package's ZeRO and comm counters. There is no pass pipeline, no tensor,
pipeline or gradient-merge plan and no compile cache: each raises or is
absent in this slice (a later port slice adds them).
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..framework import dtype as dtype_mod
from ..framework import random as random_mod
from ..framework.place import place_device
from .backward import run_backward_op
from .ir import Block, Program, Variable
from .kernels import GROUP_KERNELS, KERNELS, ExecContext

__all__ = ["Scope", "global_scope", "scope_guard", "live_ops", "op_runs",
           "run_block", "Executor", "load_numpy_state"]


class Scope:
    """name -> tensor store (the reference's framework/scope.cc, flat)."""

    def __init__(self):
        self._vars: Dict[str, Any] = {}

    def find_var(self, name):
        return self._vars.get(name)

    def var(self, name):
        return self._vars.setdefault(name, None)

    def set(self, name, value):
        self._vars[name] = value

    def keys(self):
        return self._vars.keys()

    def items(self):
        return self._vars.items()

    def drop(self, name):
        self._vars.pop(name, None)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    """Make ``scope`` the global scope inside the ``with`` block."""
    global _global_scope
    saved = _global_scope
    _global_scope = scope
    try:
        yield scope
    finally:
        _global_scope = saved


# ---------------------------------------------------------------------------
# the interpreter
# ---------------------------------------------------------------------------
def _layout(op):
    """An op's type, attrs and slot sizes: the ops of a run share them."""
    return (op.type, op.attrs,
            {s: len(n) for s, n in op.inputs.items()},
            {s: len(n) for s, n in op.outputs.items()})


def op_runs(steps):
    """``steps`` ([(op index, op)]) cut into runs, in order: a maximal
    run of consecutive ops of one ``GROUP_KERNELS`` type (the optimizer
    updates) whose attrs and slots are equal apart from the variable
    names, and in which no op reads or writes a variable that another op
    of the run writes (an op's own in-place state, Param in and ParamOut
    out, is its own); every other op is a run of one. The ops of a run
    depend on none of each other's outputs, so one launch may update
    them all."""
    runs, reads, writes = [], set(), set()
    for i, op in steps:
        r, w = set(op.input_names()), set(op.output_names())
        if runs and op.type in GROUP_KERNELS:
            head = runs[-1][0][1]
            if _layout(head) == _layout(op) and not r & writes \
                    and not w & (reads | writes):
                runs[-1].append((i, op))
                reads |= r
                writes |= w
                continue
        runs.append([(i, op)])
        reads, writes = r, w
    return runs


def _ins(op, env):
    return {slot: [env[n] for n in names]
            for slot, names in op.inputs.items()
            if all(n in env for n in names)}


def _bind(op, outs, env):
    for slot, names in op.outputs.items():
        for name, t in zip(names, outs.get(slot) or ()):
            env[name] = t


def _run_ops(steps, env: Dict[str, Any], ctx: ExecContext) -> None:
    """Run ``steps`` ([(op index, op)]) over ``env``: each run of
    :func:`op_runs` through its group kernel (outputs bound in op
    order), every other op through its own kernel."""
    for run in op_runs(steps):
        i, op = run[0]
        if op.type in ("feed", "fetch"):
            continue
        ctx.op_index = i
        group = GROUP_KERNELS.get(op.type)
        if group is not None:
            outs = group([_ins(o, env) for _, o in run], op.attrs, ctx)
            for (_, o), out in zip(run, outs):
                _bind(o, out, env)
            continue
        fn = KERNELS.get(op.type)
        if fn is None:
            raise NotImplementedError(
                f"static op {op.type!r} is not in this port slice; a later "
                "port slice adds it")
        _bind(op, fn(_ins(op, env), op.attrs, ctx), env)


def live_ops(block: Block, fetch_names: Sequence[str]):
    """[(op index, op)] of the ops a run needs: those whose outputs are
    fetched or persistable, and their producers (the JAX package's
    dead-code-elimination rule). A test-mode clone keeps a training
    program's weight-decay ops but not the backward op whose gradients
    they read; this drops them, as the JAX executor's passes do."""
    live = set(fetch_names) | {n for n, v in block.vars.items()
                               if v.persistable}
    keep = []
    for i in range(len(block.ops) - 1, -1, -1):
        op = block.ops[i]
        if set(op.output_names()) & live:
            keep.append((i, op))
            live |= set(op.input_names())
    keep.reverse()
    return keep


def run_block(block: Block, env: Dict[str, Any], ctx: ExecContext,
              steps=None, start: int = 0,
              stop_at: Optional[int] = None) -> Dict[str, Any]:
    """Interpret the ops of ``block`` (or ``steps``, [(op index, op)]
    from :func:`live_ops`) whose index is in ``[start, stop_at)`` over
    ``env`` (name -> tensor), writing each op's outputs into it; returns
    ``env``."""
    if steps is None:
        steps = list(enumerate(block.ops))
    if start or stop_at is not None:
        end = len(block.ops) if stop_at is None else stop_at
        steps = [(i, op) for i, op in steps if start <= i < end]
    if any(op.attrs.get("sub_block") is not None
           or op.attrs.get("sub_block_t") is not None for _, op in steps):
        raise NotImplementedError(
            "control flow is not in this port slice; a later port slice "
            "adds it")
    bwd = [k for k, (_, op) in enumerate(steps) if op.type == "backward"]
    if len(bwd) > 1:
        raise NotImplementedError(
            "more than one backward op in a block (calc_gradient) is not "
            "in this port slice; a later port slice adds it")
    if not bwd:
        with torch.no_grad():
            _run_ops(steps, env, ctx)
        return env
    b = bwd[0]
    op = steps[b][1]
    params = op.inputs["Params"]
    produced = {n for _, o in steps[:b] for n in o.output_names()}
    if produced & set(params):
        raise NotImplementedError(
            "gradients with respect to a variable an op writes before the "
            "backward op are not in this port slice")
    state = {p: env[p] for p in params}
    for p in params:
        env[p] = state[p].detach().requires_grad_()
    with torch.enable_grad():
        _run_ops(steps[:b], env, ctx)
    run_backward_op(op, env)
    env.update(state)      # the updates write the scope's own tensors
    with torch.no_grad():
        _run_ops(steps[b + 1:], env, ctx)
    return env


class Executor:
    """``exe = Executor(place); exe.run(program, feed=..., fetch_list=...)``.

    ``place``: a ``CPUPlace``/``CUDAPlace``, a device string, or None for
    CUDA (which raises on a machine without a GPU; the CPU is reached
    only by asking for it)."""

    def __init__(self, place=None):
        self.place = place
        self.device = place_device(place)
        self._step = 0
        # program -> {(program version, fetch names): live_ops}
        self._plans = weakref.WeakKeyDictionary()
        # program -> {data-parallel plan key: DataParallelStep}
        self._dp_steps = weakref.WeakKeyDictionary()
        self._comm_memo = self._zero_memo = None
        #: the JAX package's comm and ZeRO counters: zero_stage_active,
        #: zero_buckets, zero_state_bytes_{replicated,sharded,saved_pct},
        #: comm_buckets, allreduce_overlap_frac (gauges, set when a plan
        #: runs) and comm_quant_bytes_{sent,saved},
        #: zero_wire_bytes_{sent,saved} (summed over steps), and
        #: executor_steps (the program runs with feeds or fetches)
        self.counters: Dict[str, Any] = {}

    def _seed(self, program: Program) -> int:
        return program.random_seed or random_mod.initial_seed()

    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True,
            use_program_cache: bool = True):
        """One step: the feeds to the device, the live ops of the global
        block, the persistables written back to ``scope``, the fetches
        returned. ``use_program_cache`` is taken for the JAX signature:
        nothing is compiled, so there is no cache."""
        from .compiler import CompiledProgram
        from .ir import default_main_program

        if program is None:
            program = default_main_program()
        scope = scope or global_scope()
        if isinstance(program, CompiledProgram):
            return self._run_compiled(program, feed, fetch_list, scope,
                                      return_numpy)
        if not isinstance(program, Program):
            raise TypeError(f"Executor.run takes a Program or a "
                            f"CompiledProgram, got {type(program).__name__}")
        if not feed and not fetch_list:
            return self.run_startup(program, scope)
        if scope.find_var("__zero_layout__") is not None:
            # a ZeRO step ran on this scope: the per-variable state comes
            # back first (collective: every rank runs this step)
            from ..parallel.mesh import get_mesh
            from .stepplan import zero_flip_back

            zero_flip_back(scope, get_mesh())
        block = program.global_block
        env = {n: scope.find_var(n) for n, v in block.vars.items()
               if v.persistable and scope.find_var(n) is not None}
        for name, value in (feed or {}).items():
            env[name] = self._feed_tensor(block, name, value)
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        ctx = ExecContext(device=self.device,
                          seed=random_mod.fold_in(self._seed(program),
                                                  self._step))
        self._step += 1
        plans = self._plans.setdefault(program, {})
        key = (program._version, tuple(fetch_names))
        if key not in plans:
            plans[key] = live_ops(block, fetch_names)
        run_block(block, env, ctx, plans[key])
        self.counters["executor_steps"] = \
            self.counters.get("executor_steps", 0) + 1
        for name, desc in block.vars.items():
            if desc.persistable and name in env:
                scope.set(name, env[name].detach())
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch targets {missing} were not computed by "
                           "the program")
        fetches = [env[n].detach() for n in fetch_names]
        if return_numpy:
            return [f.cpu().numpy() for f in fetches]
        return fetches

    # -- the data-parallel CompiledProgram --------------------------------
    def _run_compiled(self, compiled, feed, fetch_list, scope,
                      return_numpy):
        """One rank's step of a ``CompiledProgram``: resolve the
        strategy, run the comm and ZeRO gates, materialise this rank's
        error-feedback and ZeRO rows (or flip the ZeRO rows back when
        ZeRO turned off), then run the plan kind (``stepplan.py``)."""
        from . import stepplan as sp
        from .compiler import check_strategy
        from .passes import resolve_comm, resolve_sharding, resolve_zero

        program, strategy = compiled._program, compiled._build_strategy
        check_strategy(strategy)
        if not feed and not fetch_list:
            return self.run_startup(program, scope)
        block = program.global_block
        shard_cfg = resolve_sharding(strategy)
        if shard_cfg is None and compiled._data_parallel:
            shard_cfg = self._data_axis_cfg()
        comm, zero = resolve_comm(strategy), resolve_zero(strategy)
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        feed = feed or {}
        mesh = axis = None
        split = {}
        if shard_cfg is not None:
            mesh, axis, g = self._rank_mesh(shard_cfg)
            split = sp.split_feeds(block, feed, axis, g)
        comm_plan = zero_plan = None
        if comm is not None:
            self._comm_memo = sp.comm_eligibility(
                program, block, comm, shard_cfg, None, feed, split,
                memo=self._comm_memo)
            comm_plan = self._comm_memo[1]
        if zero is not None:
            self._zero_memo = sp.zero_eligibility(
                program, block, zero, comm, comm_plan, shard_cfg, None,
                None, fetch_names, memo=self._zero_memo)
            zero_plan = self._zero_memo[1]
        if shard_cfg is None:
            # one rank: the plain Program step
            return self.run(program, feed=feed, fetch_list=fetch_list,
                            scope=scope, return_numpy=return_numpy)
        if zero_plan is None and scope.find_var("__zero_layout__") \
                is not None:
            sp.zero_flip_back(scope, mesh)
        rows = []
        if comm_plan is not None and comm[2]:
            rows += sp.ensure_ef_state(scope, comm_plan, self.device)
        absorbed = set()
        if zero_plan is not None:
            added, absorbed = sp.ensure_zero_state(scope, zero_plan, mesh,
                                                   self.device)
            rows += added
        plan = sp.build_plan(block, comm=comm, comm_plan=comm_plan,
                             zero_plan=zero_plan)
        split_any = any(split.values())
        key = (program._version, tuple(fetch_names), plan.kind, comm,
               zero, tuple(sorted(split.items())),
               None if comm_plan is None else repr(comm_plan[2]))
        steps = self._dp_steps.setdefault(program, {})
        if key not in steps:
            steps[key] = sp.DataParallelStep(
                plan, block, live_ops(block, fetch_names), fetch_names,
                mesh, axis, split_any, run_block)
        step = steps[key]
        self._plan_counters(plan)
        env = {n: scope.find_var(n) for n, v in block.vars.items()
               if v.persistable and scope.find_var(n) is not None}
        env.update({n: scope.find_var(n) for n in rows})
        idx, g = mesh.axis_index(axis), mesh.axis_size(axis)
        for name, value in feed.items():
            if split.get(name):
                b = value.shape[0] // g
                value = value[idx * b:(idx + 1) * b]
            env[name] = self._feed_tensor(block, name, value)
        ctx = ExecContext(device=self.device,
                          seed=random_mod.fold_in(self._seed(program),
                                                  self._step))
        self._step += 1
        fetches, new_rows = step(env, ctx)
        for name, desc in block.vars.items():
            if desc.persistable and name in env and name not in absorbed:
                scope.set(name, env[name].detach())
        for name, row in new_rows.items():
            scope.set(name, row)
        if return_numpy:
            return [f.cpu().numpy() for f in fetches]
        return fetches

    def _data_axis_cfg(self):
        """``with_data_parallel()`` without ``mesh_shape``: the global
        mesh's data axis, or None (one rank)."""
        from ..parallel.mesh import get_mesh
        from .passes import DATA_AXIS_NAMES

        mesh = get_mesh()
        for a in DATA_AXIS_NAMES:
            if mesh is not None and mesh.axis_size(a) > 1:
                return (((a, mesh.axis_size(a)),), ())
        return None

    @staticmethod
    def _rank_mesh(shard_cfg):
        """The global mesh, which must be ``mesh_shape``; its one data
        axis and size. Other meshes raise."""
        from ..parallel.mesh import get_mesh
        from .passes import comm_data_axis

        want = dict(shard_cfg[0])
        mesh = get_mesh()
        if mesh is None or mesh.shape != want:
            raise ValueError(
                f"BuildStrategy.mesh_shape {want} needs the ranks' mesh: "
                f"call parallel.create_mesh({want}) on every rank first "
                f"(the global mesh is {mesh})")
        axis = comm_data_axis(shard_cfg)
        if axis is None:
            raise NotImplementedError(
                f"mesh {want}: only a pure data-parallel mesh ('dp' or "
                "'data') is in this port slice; tensor and pipeline axes "
                "are a later port slice")
        return mesh, axis[0], axis[1]

    def _plan_counters(self, plan):
        """The JAX executor's plan gauges and per-step wire counters."""
        from . import stepplan as sp

        c = self.counters
        if plan.kind == "zero":
            zp = plan.zero_plan
            rep, sh = zp["bytes_replicated"], zp["bytes_sharded"]
            c["zero_stage_active"] = zp["stage"]
            c["zero_buckets"] = len(zp["buckets"])
            c["zero_state_bytes_replicated"] = rep
            c["zero_state_bytes_sharded"] = sh
            c["zero_state_bytes_saved_pct"] = \
                round(100.0 * (1.0 - sh / rep), 2) if rep else 0.0
        if plan.kind not in ("comm", "zero"):
            return
        stats = (sp.zero_entry_stats if plan.kind == "zero"
                 else sp.comm_entry_stats)(plan.comm_plan)
        pre = "zero_wire_bytes" if plan.kind == "zero" else \
            "comm_quant_bytes"
        for what in ("sent", "saved"):
            c[f"{pre}_{what}"] = c.get(f"{pre}_{what}", 0) + \
                stats[f"bytes_{what}"]
        c["comm_buckets"] = stats["comm_buckets"]
        c["allreduce_overlap_frac"] = stats["allreduce_overlap_frac"]

    def memory_stats(self) -> Dict[str, int]:
        """The caching allocator's view of the executor's card
        (``torch.cuda.memory_stats``): ``peak_bytes`` (the most allocated
        at once since the last peak reset), ``allocated_bytes`` and
        ``reserved_bytes`` now. {} on the CPU, as the JAX executor's is
        where its backend exposes no memory analysis."""
        if self.device.type != "cuda":
            return {}
        st = torch.cuda.memory_stats(self.device)
        return {"peak_bytes": int(st.get("allocated_bytes.all.peak", 0)),
                "allocated_bytes": int(
                    st.get("allocated_bytes.all.current", 0)),
                "reserved_bytes": int(
                    st.get("reserved_bytes.all.current", 0))}

    def _feed_tensor(self, block, name, value):
        """``value`` on the device, in the feed variable's dtype."""
        desc = block.vars.get(name)
        dt = dtype_mod.to_torch(desc.dtype) if desc is not None else None
        if isinstance(value, torch.Tensor):
            return value.to(device=self.device, dtype=dt)
        return torch.as_tensor(np.asarray(value), dtype=dt,
                               device=self.device)

    def run_startup(self, program: Program, scope: Optional[Scope] = None):
        """Run the initializer ops, writing the persistables to
        ``scope``. (``run`` on a program without feeds or fetches
        delegates here.)"""
        scope = scope or global_scope()
        ctx = ExecContext(device=self.device, seed=self._seed(program))
        block = program.global_block
        env = {n: scope.find_var(n) for n in block.vars
               if scope.find_var(n) is not None}
        run_block(block, env, ctx)
        for name, desc in block.vars.items():
            if desc.persistable and env.get(name) is not None:
                scope.set(name, env[name])
        return []


def load_numpy_state(scope: Scope, state: Dict[str, Any],
                     place=None) -> None:
    """Copy ``{name: ndarray}`` (e.g. the JAX package's scope after its
    startup program, as numpy) into ``scope`` as tensors on ``place``'s
    device (None: CUDA), each in its own dtype."""
    dev = place_device(place)
    for name, value in state.items():
        scope.set(name, torch.as_tensor(np.array(value), device=dev))
