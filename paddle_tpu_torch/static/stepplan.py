"""The data-parallel static step: what one step of a ``CompiledProgram``
with ``BuildStrategy.mesh_shape = {"dp": g}`` computes (port of the
``dp``/``comm``/``zero`` parts of ``paddle_tpu/static/stepplan.py``).

The JAX package traces each plan kind once into a program over g
devices (GSPMD, or ``shard_map``). The port runs one process per rank
(``parallel.create_mesh``; every rank calls ``Executor.run`` with the
global batch and takes its own rows of each batch feed), and a step is
a loop on the host over the interpreted block (``executor.run_block``
with ``start``/``stop_at``): the forward and backward ops on the local
rows, the gradient reduction over ``parallel.collectives``, then the
update ops. Rank positions (``mesh.axis_index``) are host constants, so
a rank's ZeRO chunk and its segment layout are fixed once per plan.
Plan kinds (:func:`build_plan`):

- ``dp``    no comm plan engaged: the local gradients are summed over the
            axis (``collectives.all_reduce``, f32) and divided by g, the
            global-batch mean gradient GSPMD gives in JAX;
- ``comm``  the explicit bucketed ring (``comm_quant`` f32, bf16 or int8,
            optional error feedback; ``_comm_step_fn`` at ``:771``):
            every bucket's reduce-scatter before any all-gather,
            ``avg=True``;
- ``zero``  ZeRO-2/3 on the engaged comm plan (``_zero_step_fn`` at
            ``:1296``): per bucket the ring's reduce-scatter feeds ONE
            chunk update (``ops/cuda/fused_optimizer.chunk_update``, K3's
            chunk entry) on this rank's un-quantized chunk and its rows
            of the sharded state; stage 2 then all-gathers the updated
            parameter chunks in raw f32, stage 3 keeps the parameters as
            rows and all-gathers them before the next forward.

Fetches: a batch-dim fetch is all-gathered over the axis (``gather``),
another float one averaged over it (``pmean``), the rest are this
rank's (``local``). A FoundInfinite flag is OR'd across ranks (``pmax``).

Where the state rows live: a rank's scope holds its own row of each
``(g, c)`` buffer of the JAX package (EF residuals ``__comm_ef_<i>``, ZeRO
rows ``__zero_<role>_<i>``) as a ``(1, c)`` tensor, plus the
``__zero_layout__`` marker; :func:`zero_flip_back` all-gathers the rows
before it un-rolls them. Gradient merge and the pipeline kinds are a
later port slice (``compiler.check_strategy`` raises on them).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..framework import dtype as dtype_mod
from ..ops.cuda import counters
from ..ops.cuda import fused_optimizer as fo
from ..parallel import collectives as C
from .passes import comm_bucket_plan, comm_data_axis

__all__ = ["StepPlan", "build_plan", "merge_region", "comm_eligibility",
           "comm_entry_stats", "zero_entry_stats", "ensure_ef_state",
           "zero_eligibility", "zero_state_layout", "ensure_zero_state",
           "zero_flip_back", "ZERO_OPT_OPS", "DataParallelStep",
           "split_feeds"]


class StepPlan:
    """What shapes one data-parallel step: the kind (``dp``, ``comm``
    or ``zero``), the comm config and bucket plan, the ZeRO plan and the
    backward op's index."""

    __slots__ = ("kind", "comm", "comm_plan", "zero_plan", "bwd_idx")

    def __init__(self, kind, *, comm=None, comm_plan=None, zero_plan=None,
                 bwd_idx=None):
        self.kind = kind
        self.comm = comm
        self.comm_plan = comm_plan
        self.zero_plan = zero_plan
        self.bwd_idx = bwd_idx


def build_plan(block, *, comm=None, comm_plan=None,
               zero_plan=None) -> StepPlan:
    """An engaged comm plan on a block with a backward op gives ``comm``
    (``zero`` with an engaged ZeRO plan), anything else ``dp``."""
    bwd_idx = next((i for i, op in enumerate(block.ops)
                    if op.type == "backward"), None)
    if comm_plan is not None and bwd_idx is not None:
        kind = "zero" if zero_plan is not None else "comm"
    else:
        kind = "dp"
    return StepPlan(kind, comm=comm, comm_plan=comm_plan,
                    zero_plan=zero_plan, bwd_idx=bwd_idx)


def merge_region(block, feed_keys, feed_vals, persist_names,
                 fetch_names, k, bwd_idx):
    """Split a training block at the backward boundary: ``(scan_end,
    grad_names, found_name, state_carry, carry_out, post_outs)``. Ops
    ``[0, scan_end)`` are the forward, the backward and an adjacent
    ``check_finite_and_unscale``; ops from ``scan_end`` on are the update
    region (``stepplan.py:167``; ``k`` is the microbatch count, 1 in
    this slice)."""
    for key, v in zip(feed_keys, feed_vals):
        shp = tuple(getattr(v, "shape", ()))
        if not shp or shp[0] % k:
            raise ValueError(
                f"gradient_merge_k={k}: feed {key!r} batch dim "
                f"{shp[0] if shp else None} is not divisible by k")
    ops = block.ops
    scan_end = bwd_idx + 1
    if scan_end < len(ops) and \
            ops[scan_end].type == "check_finite_and_unscale":
        scan_end += 1
    grad_names = list(ops[bwd_idx].outputs.get("Grads", []))
    found_name = None
    if ops[scan_end - 1].type == "check_finite_and_unscale":
        fo_ = ops[scan_end - 1].outputs.get("FoundInfinite")
        found_name = fo_[0] if fo_ else None
    produced: set = set()
    for op in ops[:scan_end]:
        produced.update(op.output_names())
    post_reads: set = set()
    post_outs: set = set()
    for op in ops[scan_end:]:
        post_reads.update(op.input_names())
        post_outs.update(op.output_names())
    special = set(grad_names) | {found_name} - {None}
    persist_set = set(persist_names)
    state_carry = sorted(produced & persist_set)
    carry_out = sorted(((post_reads | set(fetch_names)) & produced)
                       - special - persist_set)
    return (scan_end, grad_names, found_name, state_carry,
            carry_out, post_outs)


def comm_entry_stats(comm_plan) -> Dict[str, Any]:
    """Wire accounting of one comm step: the encoded ring bytes a rank
    moves (``bytes_sent``), the f32 bytes the codec saved
    (``bytes_saved``), the bucket count and the analytic overlap
    fraction (nb - 1 of nb buckets have a later bucket behind them)."""
    _axis, _g, plan = comm_plan
    sent = sum(b["ring_encoded"] for b in plan)
    f32 = sum(b["ring_f32"] for b in plan)
    nb = len(plan)
    return {"bytes_sent": int(sent), "bytes_saved": int(max(0, f32 - sent)),
            "comm_buckets": nb,
            "allreduce_overlap_frac": round((nb - 1) / nb, 4) if nb else 0.0}


def zero_entry_stats(comm_plan) -> Dict[str, Any]:
    """Wire accounting of one ZeRO step: the encoded half-ring
    reduce-scatter plus the raw-f32 half-ring all-gather, saved against
    the f32 all-reduce ring (``zero_wire_bytes_*``, kept apart from the
    ``comm_quant_*`` counters)."""
    _axis, _g, plan = comm_plan
    rs = sum(b["ring_encoded"] // 2 for b in plan)
    ag = sum(b["ring_f32"] - b["ring_f32"] // 2 for b in plan)
    f32 = sum(b["ring_f32"] for b in plan)
    nb = len(plan)
    return {"zero": True, "bytes_sent": int(rs + ag),
            "bytes_saved": int(max(0, f32 - (rs + ag))), "comm_buckets": nb,
            "allreduce_overlap_frac": round((nb - 1) / nb, 4) if nb else 0.0}


# ---------------------------------------------------------------------------
# the comm gate and its error-feedback rows
# ---------------------------------------------------------------------------
def _verdict_fn(key, name, engaged, bump):
    def verdict(result, reason=None):
        if result is None:
            bump(f"{name}.xla", reason)
        else:
            bump(f"{name}.{engaged}", None)
        return (key, result)
    return verdict


def _bump(name, reason):
    if reason is None:
        counters.bump(name)
    else:
        counters.refuse(name, reason)


def comm_eligibility(program, block, comm, shard_cfg, gm, feed, sharding,
                     pp=None, memo=None, bump=None):
    """Gate and plan of the explicit quantized-collective step
    (``stepplan.py:653``): ``(key, (axis_name, group, plan))``, or
    ``(key, None)`` after counting ``quant_allreduce.xla`` with the
    reason. ``sharding`` maps each feed to its spec (``("dp",)`` when
    its batch is split over the axis, ``()`` when every rank takes it
    whole). ``memo``: the previous return, reused without counting when
    the key is unchanged."""
    bump = bump or _bump
    key = (program._version, comm, shard_cfg, gm, pp,
           tuple(sorted((k, tuple(getattr(v, "shape", ())))
                        for k, v in feed.items())))
    if memo is not None and memo[0] == key:
        return memo
    verdict = _verdict_fn(key, "quant_allreduce", "quant", bump)
    if shard_cfg is None:
        return verdict(None, "comm_quant set but no mesh_shape — "
                             "quantized collectives need a dp mesh")
    if pp is not None:
        return verdict(None, "pipeline_stages > 1 — the pipeline "
                             "schedule keeps XLA collectives")
    axis = comm_data_axis(shard_cfg)
    if axis is None:
        return verdict(None, "mesh is not pure data-parallel "
                             f"(axes {shard_cfg[0]})")
    if shard_cfg[1]:
        return verdict(None, "sharding_hints present — tensor-"
                             "parallel layouts keep XLA collectives")
    name, g = axis
    plan = comm_bucket_plan(block, comm, g)
    if plan is None:
        return verdict(None, "no static gradient plan (no backward "
                             "op, or dynamic grad shapes)")
    ops = block.ops
    bwd_idx = next(i for i, op in enumerate(ops) if op.type == "backward")
    persist = {n for n, v in block.vars.items() if v.persistable}
    written = {n for op in ops[:bwd_idx] for n in op.output_names()
               if n in persist}
    if written:
        return verdict(None, f"persistable writes in the forward "
                             f"region ({sorted(written)[:3]}) would "
                             "diverge per-device")
    for k_, v in feed.items():
        shape = getattr(block.vars.get(k_), "shape", None)
        if not shape or shape[0] is None or int(shape[0]) >= 0:
            continue
        spec = sharding.get(k_) if sharding else None
        if not spec or not spec[0]:
            return verdict(None, f"feed {k_!r} batch dim not "
                                 f"sharded over {name!r} (size not "
                                 f"divisible by {g}?)")
        local_b = int(getattr(v, "shape", (0,))[0]) // g
        if gm is not None and local_b % gm[0]:
            return verdict(None, f"local batch {local_b} not "
                                 f"divisible by gradient_merge_k="
                                 f"{gm[0]}")
    return verdict((name, g, plan))


def ensure_ef_state(scope, comm_plan, device):
    """This rank's error-feedback residual rows: ``__comm_ef_<i>``, one
    ``(1, padded)`` f32 row per bucket (its row of the JAX package's
    ``(g, padded)`` buffer), zeros when absent. Returns the names."""
    _axis, g, plan = comm_plan
    names = []
    for i, b in enumerate(plan):
        n = f"__comm_ef_{i}"
        padded = C.padded_len(b["elems"], g)
        row = scope.find_var(n)
        if not torch.is_tensor(row) or tuple(row.shape) != (1, padded):
            scope.set(n, torch.zeros(1, padded, dtype=torch.float32,
                                     device=device))
        names.append(n)
    return names


# ---------------------------------------------------------------------------
# the zero gate, its state layout and the flip-back
# ---------------------------------------------------------------------------
# optimizer ops that run on a (chunk,) shard: sgd/momentum/adam are
# elementwise; lamb's trust ratio takes the chunk entry's two phases
ZERO_OPT_OPS = ("sgd", "momentum", "adam", "lamb")

# per-op state slots that shard into (g, chunk) rows, and the scalar
# accumulators that stay per var (the chunk update's Beta*PowOut)
_ZERO_ROLES = {"sgd": (), "momentum": ("Velocity",),
               "adam": ("Moment1", "Moment2"),
               "lamb": ("Moment1", "Moment2")}
_ZERO_SCALARS = {"sgd": (), "momentum": (),
                 "adam": ("Beta1Pow", "Beta2Pow"),
                 "lamb": ("Beta1Pow", "Beta2Pow")}


def _zero_row_sources(stage, bucket):
    """role -> source var names of one bucket's rows (the parameters
    join them at stage 3)."""
    src = {role: names for role, names in bucket["roles"].items()}
    if stage >= 3:
        src["Param"] = bucket["params"]
    return src


def _numel(shape):
    n = 1
    for d in shape or (1,):
        n *= int(d)
    return n


def zero_eligibility(program, block, zero, comm, comm_plan, shard_cfg, gm,
                     pp, fetch_names, memo=None, bump=None):
    """Gate and plan of ZeRO-2/3 (``stepplan.py:1027``): ``(key,
    zero_plan)``, or ``(key, None)`` after counting ``zero.xla`` with
    the reason. Eligible: the comm plan is engaged; every bucket's
    parameters are updated by one op type of :data:`ZERO_OPT_OPS` with
    one attrs/lr/gate; parameters and gradients are f32; no surviving
    update-region op reads a gradient, a sharded moment or (stage 3) a
    parameter; no fetch asks for absorbed state."""
    bump = bump or _bump
    key = (program._version, zero, comm, comm_plan is not None, shard_cfg,
           gm, pp, tuple(fetch_names))
    if memo is not None and memo[0] == key:
        return memo
    verdict = _verdict_fn(key, "zero", "zero", bump)
    if comm_plan is None:
        return verdict(None, "zero_stage set but the quantized comm "
                             "plan is not engaged — ZeRO rides its "
                             "bucketed ring (set comm_quant; the "
                             "quant_allreduce.xla counter has that "
                             "refusal)")
    axis, g, cplan = comm_plan
    ops = block.ops
    bwd_idx = next((i for i, op in enumerate(ops)
                    if op.type == "backward"), None)
    if bwd_idx is None:
        return verdict(None, "no backward op")
    scan_end = bwd_idx + 1
    if scan_end < len(ops) and \
            ops[scan_end].type == "check_finite_and_unscale":
        scan_end += 1
    bwd = ops[bwd_idx]
    g2p = dict(zip(bwd.outputs.get("Grads", ()),
                   bwd.inputs.get("Params", ())))
    opt_at = {}
    for i in range(scan_end, len(ops)):
        op = ops[i]
        pn = op.inputs.get("Param")
        if pn and op.inputs.get("Grad"):
            opt_at[pn[0]] = (i, op)

    def _f32(name):
        v = block.vars.get(name)
        return v is not None and dtype_mod.to_torch(v.dtype) == \
            torch.float32

    buckets = []
    absorbed: List[str] = []
    replaced: set = set()
    for bi, b in enumerate(cplan):
        params, idxs = [], []
        sig = None
        for gn in b["grads"]:
            pn = g2p.get(gn)
            if pn is None or pn not in opt_at:
                return verdict(None, f"param for grad {gn!r} has no "
                                     "optimizer op in the update "
                                     "region")
            i, op = opt_at[pn]
            if op.type not in ZERO_OPT_OPS:
                return verdict(None, f"optimizer {op.type!r} is not "
                                     "chunk-shardable; allowlist: "
                                     f"{ZERO_OPT_OPS}")
            if not _f32(pn) or not _f32(gn):
                return verdict(None, f"param/grad for {pn!r} is not "
                                     "f32 — the chunked f32 update "
                                     "would drift from the reference "
                                     "kernel's native-dtype math")
            lr = op.inputs.get("LearningRate")
            if not lr:
                return verdict(None, f"{op.type} op for {pn!r} has "
                                     "no LearningRate input")
            attrs = {a: v for a, v in sorted(op.attrs.items())
                     if not a.startswith("__")}
            s = (op.type, repr(attrs), lr[0],
                 op.inputs.get("FoundInfinite", [None])[0])
            if sig is None:
                sig = s
            elif s != sig:
                return verdict(None, f"mixed optimizer configs inside "
                                     f"comm bucket {bi} — the fused "
                                     "chunk update needs one uniform "
                                     "type/attrs/lr per bucket")
            params.append(pn)
            idxs.append(i)
        op0 = ops[idxs[0]]
        roles = {r: [ops[i].inputs[r][0] for i in idxs]
                 for r in _ZERO_ROLES[op0.type]}
        scalars = {r: [ops[i].inputs[r][0] for i in idxs]
                   for r in _ZERO_SCALARS[op0.type]}
        padded = C.padded_len(b["elems"], g)
        shapes = [tuple(int(d) for d in (block.vars[pn].shape or ()))
                  for pn in params]
        buckets.append({
            "grads": list(b["grads"]), "params": params,
            "elems": int(b["elems"]), "padded": int(padded),
            "chunk": int(padded) // g, "op_type": op0.type,
            "attrs": dict(op0.attrs), "lr": sig[2], "found": sig[3],
            "roles": roles, "scalars": scalars,
            "op_idxs": sorted(idxs), "param_shapes": shapes,
        })
        replaced.update(idxs)
        for names in roles.values():
            absorbed.extend(names)
        if zero >= 3:
            absorbed.extend(params)
    grads_all = set(g2p)
    moments_all = {n for b_ in buckets
                   for ns in b_["roles"].values() for n in ns}
    params_s3 = set(g2p.values()) if zero >= 3 else set()
    for i in range(scan_end, len(ops)):
        if i in replaced:
            continue
        reads = {n for ns in ops[i].inputs.values() for n in ns}
        for bad, what in ((reads & grads_all, "the merged gradient"),
                          (reads & moments_all,
                           "sharded optimizer state"),
                          (reads & params_s3, "stage-3 params")):
            if bad:
                return verdict(
                    None, f"post-region op {ops[i].type!r} reads "
                          f"{what} ({sorted(bad)[:2]}) which is never "
                          f"materialized under zero_stage={zero}")
    bad = set(fetch_names) & set(absorbed)
    if bad:
        return verdict(None, f"fetch of sharded state "
                             f"{sorted(bad)[:2]} under "
                             f"zero_stage={zero}")
    rep = sh = 0
    for b_ in buckets:
        nrows = len(b_["roles"]) + (1 if zero >= 3 else 0)
        rep += b_["elems"] * 4 * nrows
        sh += b_["chunk"] * 4 * nrows
    plan = {"stage": int(zero), "axis": axis, "group": int(g),
            "buckets": buckets, "scan_end": scan_end,
            "absorbed": tuple(sorted(set(absorbed))),
            "bytes_replicated": int(rep), "bytes_sharded": int(sh)}
    return verdict(plan)


def zero_state_layout(zero_plan):
    """``[(row_name, role, bucket_idx, (g, chunk))]``: the sharded rows
    the plan owns. Rows are RING-PLACED: rank r holds flat chunk
    ``(r + 1) % g`` of the bucket's padded concatenation, the chunk
    :func:`collectives.reduce_scatter` hands it."""
    g = zero_plan["group"]
    out = []
    for i, b in enumerate(zero_plan["buckets"]):
        for role in _zero_row_sources(zero_plan["stage"], b):
            out.append((f"__zero_{role.lower()}_{i}", role, i,
                        (g, b["chunk"])))
    return out


def _flat_padded(tensors, padded):
    """The tensors flattened to f32, concatenated and zero-padded."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    if flat.numel() != padded:
        flat = torch.cat([flat, flat.new_zeros(padded - flat.numel())])
    return flat


def ensure_zero_state(scope, zero_plan, mesh, device):
    """This rank's rows of the sharded state: ``(1, chunk)`` f32 per
    (bucket, role), the chunk ``(idx + 1) % g`` of the padded
    concatenation. Per-var state already in the scope (a warm start:
    velocity accumulated, moments mid-run; every rank holds all of it)
    is ABSORBED into the rows and dropped from the scope; the
    ``__zero_layout__`` marker records what :func:`zero_flip_back`
    needs. Returns ``(added_names, dropped_names)``."""
    g = zero_plan["group"]
    idx = mesh.axis_index(zero_plan["axis"])
    added = []
    for i, b in enumerate(zero_plan["buckets"]):
        c = b["chunk"]
        for role, names in _zero_row_sources(zero_plan["stage"],
                                             b).items():
            rn = f"__zero_{role.lower()}_{i}"
            row = scope.find_var(rn)
            if not torch.is_tensor(row) or tuple(row.shape) != (1, c):
                parts = []
                for n, shp in zip(names, b["param_shapes"]):
                    v = scope.find_var(n)
                    parts.append(torch.zeros(_numel(shp), device=device)
                                 if v is None else v.to(device))
                flat = _flat_padded(parts, b["padded"])
                pos = ((idx + 1) % g) * c
                scope.set(rn, flat[pos:pos + c].clone().reshape(1, c))
            added.append(rn)
    for n in zero_plan["absorbed"]:
        scope.drop(n)
    scope.set("__zero_layout__", {
        "stage": zero_plan["stage"], "group": g,
        "axis": zero_plan["axis"],
        "buckets": [{"roles": dict(b["roles"]), "params": b["params"],
                     "param_shapes": b["param_shapes"],
                     "elems": b["elems"], "chunk": b["chunk"]}
                    for b in zero_plan["buckets"]]})
    return added, set(zero_plan["absorbed"])


def zero_flip_back(scope, mesh):
    """Rebuild the per-var optimizer state (and stage-3 parameters) from
    the rows when ZeRO turns off between steps: all-gather every rank's
    row over the axis, un-roll the ring placement, strip the padding,
    split per var. Drops the rows and the marker; returns the restored
    names. Collective: every rank calls it at the same step."""
    layout = scope.find_var("__zero_layout__")
    if not isinstance(layout, dict):
        return []
    axis = layout["axis"]
    restored = []
    for i, b in enumerate(layout["buckets"]):
        for role, names in _zero_row_sources(layout["stage"], b).items():
            rn = f"__zero_{role.lower()}_{i}"
            row = scope.find_var(rn)
            if row is None:
                continue
            rows = C.all_gather(row, axis, 0, mesh)        # (g, chunk)
            flat = torch.roll(rows, 1, 0).reshape(-1)[:b["elems"]]
            off = 0
            for n, shp in zip(names, b["param_shapes"]):
                e = _numel(shp)
                scope.set(n, flat[off:off + e].reshape(shp).clone())
                restored.append(n)
                off += e
            scope.drop(rn)
    scope.drop("__zero_layout__")
    return restored


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def split_feeds(block, feed, axis, g):
    """``{feed name: spec}``: ``(axis,)`` for a feed whose variable has
    a dynamic batch dimension and whose rows divide by ``g`` (each rank
    takes its own rows), ``()`` for one every rank takes whole."""
    out = {}
    for k, v in feed.items():
        shape = getattr(block.vars.get(k), "shape", None)
        rows = tuple(getattr(v, "shape", ()))
        dyn = bool(shape) and (shape[0] is None or int(shape[0]) < 0)
        out[k] = (axis,) if dyn and rows and rows[0] % g == 0 else ()
    return out


def _fetch_modes(block, fetch_names, split):
    modes = []
    for n in fetch_names:
        v = block.vars.get(n)
        shape = getattr(v, "shape", None)
        dt = str(getattr(v, "dtype", "float32"))
        if not split:
            modes.append("local")      # every rank ran the whole batch
        elif shape and (shape[0] is None or int(shape[0]) < 0):
            modes.append("gather")
        elif dt.startswith("float") or dt == "bfloat16":
            modes.append("pmean")
        else:
            modes.append("local")
    return modes


class DataParallelStep:
    """One plan kind's step over an interpreted block, worked out once
    per plan: ``step(env, ctx) -> (fetches, rows)``. ``env`` holds the
    persistables from the scope and this rank's feeds; the update ops
    write the parameters in place or into ``env``; ``rows`` are the
    state rows the step wrote ({name: (1, c) tensor})."""

    def __init__(self, plan: StepPlan, block, steps, fetch_names, mesh,
                 axis, split, run_block):
        self.plan, self.block, self.mesh, self.axis = plan, block, mesh, axis
        self.g = mesh.axis_size(axis)
        self.idx = mesh.axis_index(axis)
        self.steps = steps
        self.fetch_names = list(fetch_names)
        self.run_block = run_block
        self.split = split
        self.modes = _fetch_modes(block, fetch_names, split)
        bwd = plan.bwd_idx
        if bwd is None:
            self.scan_end, self.grad_names, self.found_name = \
                len(block.ops), [], None
        elif plan.kind == "dp":
            # the gradient mean comes right after the backward op, so a
            # check_finite_and_unscale after it sees the global gradient
            self.scan_end = bwd + 1
            self.grad_names = list(block.ops[bwd].outputs.get("Grads", []))
            self.found_name = None
        else:
            (self.scan_end, self.grad_names, self.found_name,
             *_rest) = merge_region(block, [], [], [], fetch_names, 1, bwd)
        self.caches: Dict[int, dict] = {}
        if plan.kind == "zero":
            self._zero_setup()

    # -- the parts every kind shares ---------------------------------------
    def _forward(self, env, ctx):
        self.run_block(self.block, env, ctx, self.steps,
                       stop_at=self.scan_end)

    def _post(self, env, ctx, start=None, stop_at=None):
        self.run_block(self.block, env, ctx, self.steps,
                       start=self.scan_end if start is None else start,
                       stop_at=stop_at)

    def _pmax_found(self, env):
        if self.found_name is None:
            return
        f = env[self.found_name].reshape(()).to(torch.int32).reshape(1)
        C.all_reduce(f, [self.axis], self.mesh, op="max")
        env[self.found_name] = (f > 0).reshape(1)

    def _fetches(self, env):
        out = []
        for n, mode in zip(self.fetch_names, self.modes):
            if n not in env:
                raise KeyError(f"fetch target {n!r} was not computed by "
                               "the program")
            val = env[n].detach()
            if mode == "gather":
                val = C.all_gather(val.contiguous(), self.axis, 0,
                                   self.mesh)
            elif mode == "pmean" and val.is_floating_point():
                s = val.to(torch.float32).clone()
                C.all_reduce(s, [self.axis], self.mesh)
                val = (s / C._scalar(self.g, s)).to(val.dtype)
            out.append(val)
        return out

    def _grad_flat(self, env, names, padded):
        return _flat_padded([env[gn] for gn in names], padded)

    def _unpack(self, env, names, flat):
        off = 0
        for gn in names:
            t = env[gn]
            e = t.numel()
            env[gn] = flat[off:off + e].reshape(t.shape).to(t.dtype)
            off += e

    # -- the kinds ---------------------------------------------------------
    def __call__(self, env, ctx):
        return getattr(self, "_" + self.plan.kind)(env, ctx)

    def _dp(self, env, ctx):
        self._forward(env, ctx)
        if self.grad_names and self.split:
            flat = self._grad_flat(env, self.grad_names, sum(
                env[gn].numel() for gn in self.grad_names))
            C.all_reduce(flat, [self.axis], self.mesh)
            self._unpack(env, self.grad_names,
                         flat / C._scalar(self.g, flat))
        self._post(env, ctx)
        return self._fetches(env), {}

    def _encode_ef(self, flat, env, i, rows):
        """Error feedback: add the residual, quantize once locally, keep
        the new residual, send the dequantized contribution."""
        codec = self.plan.comm[0]
        n = f"__comm_ef_{i}"
        flat = flat + env[n][0]
        dec = C.quant_decode(*C.quant_encode(flat, codec), codec)
        rows[n] = (flat - dec).reshape(1, -1)
        return dec

    def _comm(self, env, ctx):
        codec, _bucket_bytes, ef = self.plan.comm
        _axis, g, cplan = self.plan.comm_plan
        self._forward(env, ctx)
        rows, xs = {}, []
        for i, b in enumerate(cplan):
            flat = self._grad_flat(env, b["grads"],
                                   C.padded_len(b["elems"], g))
            xs.append(self._encode_ef(flat, env, i, rows) if ef else flat)
        starts = [C.allreduce_start(x, self.axis, codec=codec,
                                    mesh=self.mesh) for x in xs]
        for b, carry in zip(cplan, starts):
            self._unpack(env, b["grads"], C.allreduce_done(carry, avg=True))
        self._pmax_found(env)
        self._post(env, ctx)
        return self._fetches(env), rows

    # -- zero --------------------------------------------------------------
    def _zero_setup(self):
        zplan = self.plan.zero_plan
        self.stage = zplan["stage"]
        self.zbuckets = zplan["buckets"]
        opt_idx = {}
        for i in range(self.scan_end, len(self.block.ops)):
            op = self.block.ops[i]
            pn = op.inputs.get("Param")
            if pn and op.inputs.get("Grad"):
                opt_idx[pn[0]] = i
        self.replaced: set = set()
        self.first_op: Dict[int, int] = {}
        for bi, b in enumerate(self.zbuckets):
            idxs = [opt_idx[pn] for pn in b["params"]]
            self.replaced.update(idxs)
            self.first_op[min(idxs)] = bi
        self.live_post = sorted(i for i, _ in self.steps
                                if i >= self.scan_end)

    def _zero(self, env, ctx):
        codec, _bucket_bytes, ef = self.plan.comm
        stage, g = self.stage, self.g
        rows = {}
        if stage >= 3:
            # the parameters live only as rows: all-gather them raw
            for bi, b in enumerate(self.zbuckets):
                full = C.ring_all_gather(env[f"__zero_param_{bi}"][0],
                                         self.axis, mesh=self.mesh)
                off = 0
                for pn, shp in zip(b["params"], b["param_shapes"]):
                    e = _numel(shp)
                    env[pn] = full[off:off + e].reshape(shp)
                    off += e
        self._forward(env, ctx)
        mine = []
        for i, b in enumerate(self.zbuckets):
            flat = self._grad_flat(env, b["grads"], b["padded"])
            if ef:
                flat = self._encode_ef(flat, env, i, rows)
            mine.append(C.reduce_scatter(flat, self.axis, codec=codec,
                                         avg=True, mesh=self.mesh))
        self._pmax_found(env)
        pos = ((self.idx + 1) % g)
        for i in self.live_post:
            bi = self.first_op.get(i)
            if bi is not None:
                self._apply_bucket(env, bi, mine[bi], pos, rows)
            if i not in self.replaced:
                self._post(env, ctx, start=i, stop_at=i + 1)
        return self._fetches(env), rows

    def _apply_bucket(self, env, bi, grad, pos, rows):
        """ONE chunk update for bucket ``bi`` on this rank's chunk."""
        b = self.zbuckets[bi]
        c = b["chunk"]
        if self.stage >= 3:
            p_chunk = env[f"__zero_param_{bi}"][0]
        else:
            p_chunk = _flat_padded([env[pn] for pn in b["params"]],
                                   b["padded"])[pos * c:(pos + 1) * c]
        ins = {"Param": [p_chunk], "Grad": [grad],
               "LearningRate": [env[b["lr"]]]}
        for role in b["roles"]:
            ins[role] = [env[f"__zero_{role.lower()}_{bi}"][0]]
        for srole, names in b["scalars"].items():
            ins[srole] = [env[names[0]]]
        if b["found"] is not None:
            ins["FoundInfinite"] = [env[b["found"]]]
        outs = fo.chunk_update(
            b["op_type"], ins, b["attrs"], mesh=self.mesh, axis=self.axis,
            param_elems=tuple(_numel(s) for s in b["param_shapes"]),
            position=pos * c, cache=self.caches.setdefault(bi, {}))
        for role in b["roles"]:
            rn = f"__zero_{role.lower()}_{bi}"
            rows[rn] = outs[role + "Out"][0].reshape(1, c)
        for srole, names in b["scalars"].items():
            for n in names:
                env[n] = outs[srole + "Out"][0]
        new_p = outs["ParamOut"][0]
        if self.stage >= 3:
            rows[f"__zero_param_{bi}"] = new_p.reshape(1, c)
            return
        # raw f32: the codec is for gradients only
        full = C.ring_all_gather(new_p, self.axis, mesh=self.mesh)
        off = 0
        for pn in b["params"]:
            old = env[pn]
            e = old.numel()
            env[pn] = full[off:off + e].reshape(old.shape).to(old.dtype)
            off += e
