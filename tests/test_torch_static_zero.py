"""The port's data-parallel ``CompiledProgram`` (plan kinds ``dp``,
``comm`` and ``zero``) against the JAX package on the CPU.

One 4-rank gloo spawn (``distributed.spawn``, ``file://`` rendezvous, the
rank bodies in ``tests/_torch_zero_ranks.py``) runs every case on
``create_mesh({"dp": 4})``: each rank feeds the global batch and takes
its quarter. The JAX oracle runs the same programs (built by the same
functions under ``unique_name.guard()``) in this process with
``mesh_shape={"dp": 4}`` over 4 of its 8 virtual devices, from the same
startup state (the JAX startup scope, carried across with
``static.load_numpy_state``). Nets: ``tests/test_pipeline_zero.py``'s
``_dp_net`` (16 -> 64 -> 32 -> 4, batch 16; 3,300 parameters in one
bucket padded to 4,096, so the rank chunks of 1,024 put a parameter
boundary on a chunk edge (fc_w_0 ends at 1,024) and others inside
chunks), and the book's recognize_digits conv net (batch 64; 18,378
parameters).

Tolerances: losses within 1e-5 of JAX for the f32 codecs and the
replicated step (the frameworks' f32 gradients differ in the last bits);
the int8 and bf16 legs within JAX's own 1e-2 comm gate of JAX's run of
the same leg; Lamb ZeRO within rtol 1e-5 + atol 1e-6 of the port's
replicated comm step (the norm sums re-associate across ranks).
Persistables after the steps: atol 1e-5 + rtol 1e-4 for f32 legs, atol
1e-3 for quantized legs (a last-bit gradient difference can move an
int8 rounding by one step). The port's own contracts are bitwise: ZeRO
f32 is the comm f32 step through absorb and flip-back, stage 3 too, a
refused ZeRO request is the replicated step, and every rank reports the
same losses. The plan counters, verdicts and refusal reasons equal
JAX's.
"""
import numpy as np
import pytest

import paddle_tpu.static as js
from paddle_tpu import profiler as jprofiler
from paddle_tpu.ops.pallas import counters as jcounters
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.static as ts
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.utils import unique_name as tun

import _torch_zero_ranks as ranks

G = 4
F32 = {"comm_quant": "f32"}
Z2 = {"comm_quant": "f32", "zero_stage": 2}
Z3 = {"comm_quant": "f32", "zero_stage": 3}
I8 = {"comm_quant": "int8"}
Z2I8 = {"comm_quant": "int8", "zero_stage": 2}
EF = {"comm_quant": "int8", "comm_error_feedback": True}
Z3EF = {"comm_quant": "int8", "comm_error_feedback": True, "zero_stage": 3}
BF16 = {"comm_quant": "bf16"}
Z2BF16 = {"comm_quant": "bf16", "zero_stage": 2}

# name: (net, opt, legs, steps a leg, fetch the first velocity)
CASES = {
    "momentum_comm_f32": ("dp_net", "momentum", [F32] * 3, 2, False),
    "momentum_mix": ("dp_net", "momentum", [F32, Z2, F32], 2, False),
    "momentum_zero3": ("dp_net", "momentum", [Z3] * 2, 2, False),
    "momentum_zero3_off": ("dp_net", "momentum", [Z3, F32], 2, False),
    "momentum_zero2_then_program": ("dp_net", "momentum", [Z2, None], 2,
                                    False),
    "momentum_dp": ("dp_net", "momentum", [{}] * 2, 2, False),
    "momentum_with_data_parallel": ("dp_net", "momentum",
                                    ["with_data_parallel"] * 2, 2, False),
    "momentum_dp_zero_refused": ("dp_net", "momentum", [{"zero_stage": 2}]
                                 * 2, 2, False),
    "momentum_zero_fetch_refused": ("dp_net", "momentum", [Z2], 2, True),
    "sgd_comm_f32": ("dp_net", "sgd", [F32] * 2, 2, False),
    "sgd_zero2_f32": ("dp_net", "sgd", [Z2] * 2, 2, False),
    "sgd_comm_int8_ef": ("dp_net", "sgd", [EF] * 2, 2, False),
    "sgd_zero3_int8_ef": ("dp_net", "sgd", [Z3EF] * 2, 2, False),
    "adam_comm_f32": ("dp_net", "adam", [F32] * 2, 2, False),
    "adam_zero2_f32": ("dp_net", "adam", [Z2] * 2, 2, False),
    "adam_comm_int8": ("dp_net", "adam", [I8] * 3, 2, False),
    "adam_zero2_int8": ("dp_net", "adam", [Z2I8] * 3, 2, False),
    "adam_comm_bf16": ("dp_net", "adam", [BF16] * 2, 2, False),
    "adam_zero2_bf16": ("dp_net", "adam", [Z2BF16] * 2, 2, False),
    "lamb_comm_f32": ("dp_net", "lamb", [F32] * 2, 2, False),
    "lamb_zero2_f32": ("dp_net", "lamb", [Z2] * 2, 2, False),
    "lamb_zero3_f32": ("dp_net", "lamb", [Z3] * 2, 2, False),
    "book_lamb_comm_f32": ("book_net", "lamb", [F32] * 3, 1, False),
    "book_lamb_zero2_f32": ("book_net", "lamb", [Z2] * 3, 1, False),
    "book_adam_zero2_int8": ("book_net", "adam", [Z2I8] * 2, 1, False),
    "book_momentum_dp": ("book_net", "momentum", [{}] * 2, 1, False),
}
QUANT = {n for n, c in CASES.items()
         if any(isinstance(leg, dict) and leg.get("comm_quant")
                in ("int8", "bf16") for leg in c[2])}
COUNTER_KEYS = ("zero_stage_active", "zero_buckets",
                "zero_state_bytes_replicated", "zero_state_bytes_sharded",
                "zero_state_bytes_saved_pct", "comm_buckets",
                "allreduce_overlap_frac", "comm_quant_bytes_sent",
                "comm_quant_bytes_saved", "zero_wire_bytes_sent",
                "zero_wire_bytes_saved")
VERDICTS = ("quant_allreduce.quant", "quant_allreduce.xla", "zero.zero",
            "zero.xla")
# summed over steps; the JAX package keeps the comm_quant pair (and the
# comm_buckets / allreduce_overlap_frac gauges) process-wide, the port
# per executor, so the oracle reads a difference
ADDITIVE = ("comm_quant_bytes_sent", "comm_quant_bytes_saved",
            "zero_wire_bytes_sent", "zero_wire_bytes_saved")
JAX_GLOBAL = ("comm_quant_bytes_sent", "comm_quant_bytes_saved",
              "comm_buckets", "allreduce_overlap_frac")


def _feed(net):
    rng = np.random.RandomState(5)
    if net == "dp_net":
        return {"x": rng.randn(16, 16).astype(np.float32),
                "label": rng.randint(0, 4, (16, 1)).astype(np.int64)}
    return {"img": rng.rand(64, 1, 28, 28).astype(np.float32),
            "label": rng.randint(0, 10, (64, 1)).astype(np.int64)}


def _init(net, opt):
    """The JAX startup scope as numpy."""
    _main, startup, _loss, _extra = ranks.NETS[net](js, jun, opt)
    scope = js.Scope()
    with js.scope_guard(scope):
        js.Executor().run(startup)
    return {k: np.asarray(v) for k, v in scope.items() if v is not None}


def _jax_counters(exe, before, verdicts):
    """This run's share of the JAX executor's counters: the additive
    ones from 0; the process-wide gauges only where a comm plan ran."""
    got = dict(exe.counters)
    out = {k: got.get(k, 0) - (before.get(k, 0) if k in JAX_GLOBAL else 0)
           for k in ADDITIVE}
    ran = any(k == "quant_allreduce.quant" for k, _ in verdicts)
    for k in COUNTER_KEYS:
        if k not in ADDITIVE and k in got and (ran or k not in JAX_GLOBAL):
            out[k] = got[k]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (jax result, [port result by rank], init)}."""
    inits, jax_runs, cases = {}, {}, []
    for name, (net, opt, legs, steps, vel) in CASES.items():
        init = inits.setdefault((net, opt), _init(net, opt))
        feed = _feed(net)
        seen = []
        real = jcounters.bump

        def bump(kernel, path, reason="", _seen=seen):
            if kernel in ("zero", "quant_allreduce"):
                _seen.append((f"{kernel}.{path}", reason))
            real(kernel, path, reason)

        jcounters.bump = bump
        before = jprofiler.counters_snapshot()
        mesh = jmesh.get_mesh()    # with_data_parallel may set one
        try:
            scope, exe = js.Scope(), js.Executor()
            for k, v in init.items():
                scope.set(k, v)
            with js.scope_guard(scope):
                losses, extras = ranks.run_legs(js, jun, exe, scope, net,
                                                opt, feed, legs, steps, G,
                                                vel)
        finally:
            jcounters.bump = real
            jmesh.set_mesh(mesh)
        jax_runs[name] = {
            "losses": losses, "extras": extras,
            "counters": _jax_counters(exe, before, seen),
            "verdicts": seen,
            "scope": {k: np.asarray(v) for k, v in scope.items()
                      if v is not None and not isinstance(v, dict)}}
        cases.append((name, net, opt, init, feed, legs, steps, vel))
    path = tmp_path_factory.mktemp("zero4") / "rendezvous"
    port = spawn(ranks.zero_rank, args=(G, cases), nprocs=G,
                 init_method=f"file://{path}", timeout=300)
    return {name: (jax_runs[name], [p[name] for p in port],
                   inits[CASES[name][:2]]) for name in CASES}, port


def _ok(port):
    for r, got in enumerate(port):
        assert "error" not in got, f"rank {r}: {got.get('error')}"
    return port


def test_ranks_are_the_mesh_rows(runs):
    _, port = runs
    assert [p["coords"] for p in port] == [{"dp": r} for r in range(G)]


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_jax(runs, name):
    jax, port, _ = runs[0][name]
    tol = 1e-2 if name in QUANT else 1e-5
    for got in _ok(port):
        np.testing.assert_allclose(got["losses"], jax["losses"], rtol=0,
                                   atol=tol)
        for ge, je in zip(got["extras"], jax["extras"]):
            for a, b in zip(ge, je):
                if a.dtype.kind == "f":
                    np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_reports_the_same_values(runs, name):
    _, port, _ = runs[0][name]
    first = _ok(port)[0]
    for got in port[1:]:
        assert got["losses"] == first["losses"]
        for ge, fe in zip(got["extras"], first["extras"]):
            for a, b in zip(ge, fe):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_persistables_after_the_steps_match_jax(runs, name):
    """Every state JAX keeps, the port's rank r keeps (a ZeRO or EF row
    buffer: rank r's row of JAX's (g, c) array), and nothing else."""
    jax, port, _ = runs[0][name]
    atol, rtol = (1e-3, 0.0) if name in QUANT else (1e-5, 1e-4)
    for r, got in enumerate(_ok(port)):
        assert set(got["scope"]) == set(jax["scope"]), r
        for k, want in jax["scope"].items():
            if k.startswith("__"):
                want = want[r:r + 1]
            np.testing.assert_allclose(got["scope"][k], want, rtol=rtol,
                                       atol=atol, err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("name", list(CASES))
def test_plan_counters_and_verdicts_match_jax(runs, name):
    jax, port, _ = runs[0][name]
    verdicts = {}
    for key, _reason in jax["verdicts"]:
        verdicts[key] = verdicts.get(key, 0) + 1
    for got in _ok(port):
        mine = {k: got["counters"].get(k, 0) for k in ADDITIVE}
        mine.update({k: v for k, v in got["counters"].items()
                     if k in COUNTER_KEYS and k not in ADDITIVE})
        assert mine == jax["counters"]
        assert {k: v for k, v in got["launches"].items()
                if k in VERDICTS} == verdicts
        # on the CPU no kernel launches: the plain versions ran
        assert set(got["launches"]) <= set(VERDICTS)
        for key in ("quant_allreduce.xla", "zero.xla"):
            assert got["reasons"].get(key, []) == [
                reason for k, reason in jax["verdicts"] if k == key]


BITWISE = {"momentum_mix": "momentum_comm_f32",
           "momentum_zero3": "momentum_comm_f32",
           "momentum_zero3_off": "momentum_comm_f32",
           "momentum_dp_zero_refused": "momentum_dp",
           "momentum_with_data_parallel": "momentum_dp",
           "sgd_zero2_f32": "sgd_comm_f32",
           "adam_zero2_f32": "adam_comm_f32"}


@pytest.mark.parametrize("name", list(BITWISE))
def test_zero_f32_is_the_replicated_step_bit_for_bit(runs, name):
    """ZeRO with the f32 codec is the comm f32 step bit for bit through
    absorb (a warm start) and flip-back; stage 3 too; a refused ZeRO
    request is the replicated step."""
    _, port, _ = runs[0][name]
    _, base, _ = runs[0][BITWISE[name]]
    for got, want in zip(_ok(port), _ok(base)):
        n = len(got["losses"])
        assert got["losses"] == want["losses"][:n]


@pytest.mark.parametrize("name", ["lamb_zero2_f32", "lamb_zero3_f32",
                                  "book_lamb_zero2_f32"])
def test_lamb_zero_tracks_the_replicated_step(runs, name):
    _, port, _ = runs[0][name]
    base = "book_lamb_comm_f32" if name.startswith("book") \
        else "lamb_comm_f32"
    _, want, _ = runs[0][base]
    for got, w in zip(_ok(port), _ok(want)):
        np.testing.assert_allclose(got["losses"],
                                   w["losses"][:len(got["losses"])],
                                   rtol=1e-5, atol=1e-6)


def test_int8_zero_tracks_the_replicated_int8_step(runs):
    _, port, _ = runs[0]["adam_zero2_int8"]
    _, base, _ = runs[0]["adam_comm_int8"]
    for got, want in zip(_ok(port), _ok(base)):
        assert np.max(np.abs(np.subtract(got["losses"],
                                         want["losses"]))) <= 1e-2


def _state_names(case, role):
    main = ranks.NETS[CASES[case][0]](ts, tun, CASES[case][1])[0]
    return [op.inputs[role][0] for op in main.global_block.ops
            if role in op.inputs and op.inputs.get("Grad")]


@pytest.mark.parametrize("case,role,rows", [
    ("momentum_zero3", "Velocity", ("__zero_velocity_0", "__zero_param_0")),
    ("momentum_zero3", "Param", ("__zero_param_0",)),
    ("adam_zero2_int8", "Moment1", ("__zero_moment1_0",
                                    "__zero_moment2_0")),
    ("lamb_zero2_f32", "Moment2", ("__zero_moment1_0",
                                   "__zero_moment2_0")),
])
def test_sharded_state_lives_only_in_rows(runs, case, role, rows):
    """The absorbed per-var state left every rank's scope; each rank
    holds its (1, c) row of each buffer and the layout marker."""
    _, port, _ = runs[0][case]
    names = _state_names(case, role)
    assert names
    for got in _ok(port):
        assert not set(names) & set(got["scope"])
        for rn in rows:
            assert got["scope"][rn].shape[0] == 1
        assert got["layout"]


@pytest.mark.parametrize("case", ["momentum_mix", "momentum_zero3_off",
                                  "momentum_zero2_then_program"])
def test_flip_back_restores_per_var_state(runs, case):
    _, port, _ = runs[0][case]
    for got in _ok(port):
        assert not [k for k in got["scope"] if k.startswith("__zero")]
        assert not got["layout"]
        for role in ("Velocity", "Param"):
            assert set(_state_names(case, role)) <= set(got["scope"])


@pytest.mark.parametrize("name", ["momentum_dp", "book_momentum_dp"])
def test_dp_step_is_the_one_rank_global_batch_step(runs, name):
    """The replicated step over 4 ranks against the plain Program on the
    whole batch in one process, within 1e-5."""
    _, port, init = runs[0][name]
    net, opt, legs, steps, _vel = CASES[name]
    scope, exe = ts.Scope(), ts.Executor(ts.CPUPlace())
    ts.load_numpy_state(scope, init, ts.CPUPlace())
    losses, _ = ranks.run_legs(ts, tun, exe, scope, net, opt, _feed(net),
                               [None] * len(legs), steps, G)
    for got in _ok(port):
        np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,key,reason", [
    ("momentum_dp_zero_refused", "zero.xla", "quantized comm plan is not "
                                             "engaged"),
    ("momentum_zero_fetch_refused", "zero.xla", "fetch of sharded state"),
])
def test_refusals_are_counted_with_reasons(runs, name, key, reason):
    _, port, _ = runs[0][name]
    for got in _ok(port):
        assert got["launches"].get(key, 0) >= 1
        assert all(reason in r for r in got["reasons"][key])
        assert not got["layout"]


def test_one_rank_compiled_program_is_the_plain_step():
    """Without a mesh (mesh_shape {"dp": 1} drops the axis) the
    CompiledProgram runs the plain Program step, with the JAX package's
    counted refusal for comm_quant."""
    from paddle_tpu_torch.ops.cuda import counters

    init = _init("dp_net", "momentum")
    feed = _feed("dp_net")
    got = []
    counters.reset()
    try:
        for legs in ([None] * 2,
                     [{"comm_quant": "int8", "zero_stage": 2}] * 2):
            scope, exe = ts.Scope(), ts.Executor(ts.CPUPlace())
            ts.load_numpy_state(scope, init, ts.CPUPlace())
            got.append(ranks.run_legs(ts, tun, exe, scope, "dp_net",
                                      "momentum", feed, legs, 2, 1)[0])
        assert got[0] == got[1]
        assert counters.get("quant_allreduce.xla") == 1
        assert counters.get("zero.xla") == 1
        assert "no mesh_shape" in counters.reasons("quant_allreduce.xla")[0]
    finally:
        counters.reset()        # leave nothing for a later test to read


@pytest.mark.parametrize("field,value", [
    ("amp", True), ("recompute", True), ("gradient_merge_k", 2),
    ("pipeline_stages", 2), ("sharding_hints", {"fc_w_0": (None, "dp")})])
def test_later_slice_knobs_raise(field, value):
    main, _startup, loss, _ = ranks.dp_net(ts, tun, "sgd")
    bs = ts.BuildStrategy()
    setattr(bs, field, value)
    with pytest.raises(NotImplementedError, match="later port slice"):
        ts.Executor(ts.CPUPlace()).run(
            ts.CompiledProgram(main, build_strategy=bs),
            feed=_feed("dp_net"), fetch_list=[loss], scope=ts.Scope())


def test_build_strategy_has_the_jax_fields_and_defaults():
    assert vars(ts.BuildStrategy()) == vars(js.BuildStrategy())
    assert vars(ts.ExecutionStrategy()) == vars(js.ExecutionStrategy())


def test_a_mesh_that_is_not_the_strategy_raises():
    main, _startup, loss, _ = ranks.dp_net(ts, tun, "sgd")
    bs = ts.BuildStrategy()
    bs.mesh_shape = {"dp": 4}
    with pytest.raises(ValueError, match="create_mesh"):
        ts.Executor(ts.CPUPlace()).run(
            ts.CompiledProgram(main, build_strategy=bs),
            feed=_feed("dp_net"), fetch_list=[loss], scope=ts.Scope())
