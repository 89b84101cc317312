"""Build-strategy resolution and the gradient bucket plan of the
data-parallel static step (the part of ``paddle_tpu/static/passes.py``
that ``CompiledProgram`` needs in this slice).

- :func:`resolve_sharding` (``passes.py:203``): the mesh axes of
  ``BuildStrategy.mesh_shape``; tensor-parallel ``sharding_hints`` raise.
- :func:`resolve_comm` (``:378``) and :func:`resolve_zero` (``:314``):
  the quantized-collective and ZeRO requests. The JAX package's
  ``PADDLE_QUANT_ALLREDUCE`` / ``PADDLE_ZERO`` / ``PADDLE_IR_PASSES``
  environment overrides are not ported: the port takes no setting from
  the environment.
- :func:`comm_data_axis` (``:419``) and :func:`comm_bucket_plan`
  (``:436``): gradients ordered by backward completion and packed
  greedily into buckets of ``comm_bucket_bytes`` f32 payload, the same
  plan, bucket for bucket, as the JAX package's on the same program.

The IR pass pipeline itself (constant folding, CSE, fusion, AMP,
recompute, shard propagation, pipeline stages) is a later port slice.
"""
from __future__ import annotations

from ..ps.codec import encoded_nbytes, ring_nbytes

__all__ = ["DATA_AXIS_NAMES", "resolve_sharding", "resolve_comm",
           "resolve_zero", "comm_data_axis", "comm_bucket_plan"]

#: mesh axes that carry the batch dimension (``parallel/mesh.py:30``)
DATA_AXIS_NAMES = ("dp", "data")


def resolve_sharding(strategy=None):
    """``(mesh_axes, hints)`` or None (one rank): ``mesh_axes`` is a
    tuple of ``(axis_name, size)`` in ``mesh_shape`` order with axes of
    size <= 1 dropped; ``hints`` is always ``()`` here, since
    ``sharding_hints`` (tensor parallelism) raise."""
    if strategy is None:
        return None
    if getattr(strategy, "sharding_hints", None):
        raise NotImplementedError(
            "BuildStrategy.sharding_hints (tensor-parallel layouts) are "
            "not in this port slice; a later port slice adds them")
    shape = getattr(strategy, "mesh_shape", None) or {}
    try:
        axes = tuple((str(k), int(v)) for k, v in shape.items()
                     if int(v) > 1)
    except (TypeError, ValueError, AttributeError):
        raise ValueError(f"BuildStrategy.mesh_shape={shape!r}: expected "
                         "{axis_name: int_size}")
    return (axes, ()) if axes else None


def resolve_zero(strategy=None):
    """2 or 3 (``BuildStrategy.zero_stage``), or None for stage 0. A
    stage is a request: ``stepplan.zero_eligibility`` decides."""
    if strategy is None:
        return None
    try:
        stage = int(getattr(strategy, "zero_stage", 0) or 0)
    except (TypeError, ValueError):
        stage = 0
    if stage == 0:
        return None
    if stage not in (2, 3):
        raise ValueError(
            f"BuildStrategy.zero_stage={stage!r}: expected 0|2|3")
    return stage


def resolve_comm(strategy=None):
    """``(codec, bucket_bytes, error_feedback)`` from ``comm_quant``
    ("int8" | "bf16" | "f32": the same explicit ring with no rounding),
    ``comm_bucket_bytes`` and ``comm_error_feedback``, or None
    ("off")."""
    try:
        bucket = int(getattr(strategy, "comm_bucket_bytes", 4 << 20)
                     or (4 << 20))
    except (TypeError, ValueError):
        bucket = 4 << 20
    ef = bool(getattr(strategy, "comm_error_feedback", False))
    raw = str(getattr(strategy, "comm_quant", "off") or "off").lower()
    if raw in ("off", "none", "false", "0", ""):
        return None
    if raw not in ("int8", "bf16", "f32"):
        raise ValueError(f"BuildStrategy.comm_quant={raw!r}: "
                         "expected int8|bf16|f32|off")
    return (raw, bucket, ef)


def comm_data_axis(shard_cfg):
    """``(axis_name, size)`` when the resolved mesh has exactly one axis
    and it is data-like ('dp'/'data'), else None."""
    if shard_cfg is None:
        return None
    axes = shard_cfg[0]
    if len(axes) != 1 or axes[0][0] not in DATA_AXIS_NAMES:
        return None
    name, size = axes[0]
    return (name, int(size)) if size > 1 else None


def comm_bucket_plan(block, comm, group: int):
    """Gradient buckets in BACKWARD-COMPLETION order: a parameter's
    gradient completes when the backward reaches its last forward use,
    so gradients sort by descending index of their parameter's last
    forward consumer and pack greedily into buckets of
    ``comm_bucket_bytes`` f32 payload. A list of ``{"grads", "elems",
    "f32_bytes", "encoded_bytes", "ring_f32", "ring_encoded"}``, or None
    without a backward op or with a dynamic gradient shape."""
    codec, bucket_bytes, _ef = comm
    bwd = next((op for op in block.ops if op.type == "backward"), None)
    if bwd is None:
        return None
    params = list(bwd.inputs.get("Params", ()))
    grads = list(bwd.outputs.get("Grads", ()))
    if not grads or len(params) != len(grads):
        return None
    bwd_idx = block.ops.index(bwd)
    last_use = {}
    for i, op in enumerate(block.ops[:bwd_idx]):
        for n in op.input_names():
            last_use[n] = i
    pairs = []
    for j, (p, g) in enumerate(zip(params, grads)):
        shape = getattr(block.vars.get(g), "shape", None)
        if not shape or any(d is None or int(d) < 0 for d in shape):
            return None
        elems = 1
        for d in shape:
            elems *= int(d)
        pairs.append((-(last_use.get(p, -1)), j, g, elems))
    pairs.sort()   # descending last forward use == completion order
    buckets = []
    cur, cur_elems = [], 0
    for _, _, g, elems in pairs:
        if cur and (cur_elems + elems) * 4 > bucket_bytes:
            buckets.append((cur, cur_elems))
            cur, cur_elems = [], 0
        cur.append(g)
        cur_elems += elems
    if cur:
        buckets.append((cur, cur_elems))
    return [{"grads": names, "elems": elems, "f32_bytes": 4 * elems,
             "encoded_bytes": encoded_nbytes(elems, codec),
             "ring_f32": ring_nbytes(elems, group, "f32"),
             "ring_encoded": ring_nbytes(elems, group, codec)}
            for names, elems in buckets]
