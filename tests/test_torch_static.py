"""The port's static graph (``paddle_tpu_torch.static``) against the JAX
package's (``paddle_tpu.static``) on the CPU, the JAX package as oracle.

The network is ``examples/train_resnet_static.py``'s (a small ResNet on
3 x 32 x 32 images, batch 8 here), built by both packages under
``unique_name.guard()``:

- program parity: main and startup ``to_dict()`` identical, and each
  package's ``serialize_to_string()`` parses in the other to the same
  dict;
- training parity: the JAX startup program's scope carried across with
  ``load_numpy_state``, then 5 steps with Momentum, Adam, Lamb and SGD
  with L2 decay; losses within rtol 1e-4, the accuracy fetch equal, and
  after step 5 every persistable (parameters, velocities, moments,
  beta-pows, batch-norm running statistics) within atol 1e-5 + rtol
  1e-4; the step-1 ``@GRAD`` variables within atol 1e-5 + rtol 1e-4;
- the ``clone(for_test=True)`` logits; inference models saved by one
  package load and run in the other with the same logits.

Learning rates are smaller than the example's (Momentum 1e-3 against
0.05, Adam and Lamb 1e-4): at batch 8 the example's rates make the
state after 5 steps amplify the two frameworks' last-bit differences in
the convolution sums past 1e-4 (measured: Momentum at 0.05 and Lamb at
1e-3 do), which is not what this test checks. For the same reason every
step trains on one batch (as ``bench.py``'s training configurations
do): with a fresh batch each step, the second step's f32 gradients of
both packages differ from a float64 evaluation by up to 2e-3 (of 0.04),
and from each other by as much (measured). The JAX programs run in
their own ``static.Scope()`` without ``paddle.enable_static()``.
"""
import contextlib
import os
import pickle

import numpy as np
import pytest
import torch

import paddle_tpu.static as js
from paddle_tpu.regularizer import L2Decay as JL2Decay
from paddle_tpu.utils import unique_name as jun
import paddle_tpu_torch.static as ts
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.regularizer import L2Decay as TL2Decay
from paddle_tpu_torch.utils import unique_name as tun

CPU = ts.CPUPlace()
BATCH, STEPS = 8, 5
OPTS = ("momentum", "adam", "lamb", "sgd")


def _optimizer(static, opt):
    if opt == "momentum":
        return static.Momentum(learning_rate=1e-3, momentum=0.9)
    if opt == "adam":
        return static.Adam(1e-4)
    if opt == "lamb":
        return static.Lamb(1e-4)
    reg = JL2Decay(1e-3) if static is js else TL2Decay(1e-3)
    return static.SGD(1e-3, regularization=reg)


def build(static, un, opt):
    """The example's program pair: (main, startup, loss, acc, logits)."""
    def conv_bn(x, ch, stride=1, act="relu"):
        h = static.nn.conv2d(x, ch, 3, stride=stride, padding=1,
                             bias_attr=False)
        return static.nn.batch_norm(h, act=act)

    def basic_block(x, ch, stride=1):
        h = conv_bn(x, ch, stride)
        h = conv_bn(h, ch, act=None)
        short = x if stride == 1 and x.shape[1] == ch else \
            static.nn.conv2d(x, ch, 1, stride=stride, bias_attr=False)
        return static.relu(static.elementwise_add(h, short))

    with un.guard():
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            img = static.data("img", [-1, 3, 32, 32])
            label = static.data("label", [-1, 1], dtype="int64")
            h = conv_bn(img, 16)
            h = basic_block(h, 16)
            h = basic_block(h, 32, stride=2)
            h = basic_block(h, 64, stride=2)
            h = static.nn.pool2d(h, 8, pool_type="avg")
            logits = static.nn.fc(h, 10)
            loss = static.mean(
                static.softmax_with_cross_entropy(logits, label))
            acc = static.accuracy(static.softmax(logits), label)
            _optimizer(static, opt).minimize(loss)
    return main, startup, loss, acc, logits


def _batches():
    """The training batch, fed at every step, and the evaluation batch."""
    rng = np.random.RandomState(0)
    return [(rng.randn(BATCH, 3, 32, 32).astype(np.float32),
             rng.randint(0, 10, (BATCH, 1)).astype(np.int64))
            for _ in range(2)]


def _counted_since(before):
    """The counts bumped since the snapshot ``before``: this run's own,
    whatever an earlier test left in the process-wide counters."""
    return {k: n - before.get(k, 0) for k, n in counters.snapshot().items()
            if n != before.get(k, 0)}


@contextlib.contextmanager
def _runs_seen(opt):
    """The sizes of the runs of ``opt``'s update ops that the port's
    executor hands to the group kernel, in order (a list filled while
    the block runs)."""
    from paddle_tpu_torch.static.kernels import GROUP_KERNELS

    sizes = []
    real = GROUP_KERNELS[opt]

    def spy(ins_list, attrs, ctx):
        sizes.append(len(ins_list))
        return real(ins_list, attrs, ctx)
    GROUP_KERNELS[opt] = spy
    try:
        yield sizes
    finally:
        GROUP_KERNELS[opt] = real


def _train(opt):
    """Both packages from the JAX startup state: per-step (loss, acc),
    step-1 grads, the state after STEPS steps, eval logits."""
    batches = _batches()
    jm, jsu, jloss, jacc, jlogits = build(js, jun, opt)
    tm, tsu, tloss, tacc, tlogits = build(ts, tun, opt)
    grads = sorted(n for n in jm.global_block.vars if n.endswith("@GRAD"))
    out = {"grad_names": grads, "jax": {}, "port": {}}
    jscope, tscope = js.Scope(), ts.Scope()
    with js.scope_guard(jscope):
        jexe = js.Executor()
        jexe.run(jsu)
        init = {k: np.asarray(v) for k, v in jscope.items()}
    texe = ts.Executor(CPU)
    ts.load_numpy_state(tscope, init, CPU)
    for side, static, exe, scope, prog, fetch in (
            ("jax", js, jexe, jscope, jm, [jloss, jacc] + grads),
            ("port", ts, texe, tscope, tm, [tloss, tacc] + grads)):
        rec = out[side]
        with static.scope_guard(scope):
            before = counters.snapshot()
            with _runs_seen(opt) as rec["runs"]:
                rec["steps"] = [exe.run(prog, feed={"img": x, "label": y},
                                        fetch_list=fetch)
                                for x, y in batches[:1] * STEPS]
            rec["launches"] = _counted_since(before)
            rec["state"] = {k: np.asarray(v) if side == "jax"
                            else v.numpy() for k, v in scope.items()}
            x, y = batches[1]
            logits = jlogits if side == "jax" else tlogits
            rec["eval"] = exe.run(prog.clone(for_test=True),
                                  feed={"img": x, "label": y},
                                  fetch_list=[logits])[0]
        rec.update(exe=exe, scope=scope, main=prog, logits=logits)
    out["eval_batch"] = batches[1][0]
    return out


@pytest.fixture(scope="module")
def trained():
    cache = {}

    def get(opt):
        if opt not in cache:
            cache[opt] = _train(opt)
        return cache[opt]
    return get


def _close(got, want, atol=1e-5, rtol=1e-4, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=msg)


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt", OPTS)
def test_program_dicts_are_identical(opt):
    jm, jsu = build(js, jun, opt)[:2]
    tm, tsu = build(ts, tun, opt)[:2]
    assert tm.to_dict() == jm.to_dict()
    assert tsu.to_dict() == jsu.to_dict()
    assert tm.clone(for_test=True).to_dict() == \
        jm.clone(for_test=True).to_dict()
    n_update = sum(op.type == ("sgd" if opt == "sgd" else opt)
                   for op in tm.global_block.ops)
    assert n_update == 25


@pytest.mark.parametrize("opt", ("momentum", "lamb"))
def test_serialized_programs_parse_in_the_other_package(opt):
    jm = build(js, jun, opt)[0]
    tm = build(ts, tun, opt)[0]
    assert tm.serialize_to_string() == jm.serialize_to_string()
    assert ts.Program.parse_from_string(
        jm.serialize_to_string()).to_dict() == jm.to_dict()
    assert js.Program.parse_from_string(
        tm.serialize_to_string()).to_dict() == tm.to_dict()


def test_save_program_files_load_in_the_other_package(tmp_path):
    jm = build(js, jun, "adam")[0]
    tm = build(ts, tun, "adam")[0]
    js.save_program(jm, str(tmp_path / "jax_prog"))
    ts.save_program(tm, str(tmp_path / "port_prog"))
    assert ts.load_program(str(tmp_path / "jax_prog")).to_dict() == \
        jm.to_dict()
    assert js.load_program(str(tmp_path / "port_prog")).to_dict() == \
        tm.to_dict()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt", OPTS)
def test_five_steps_match_jax(trained, opt):
    run = trained(opt)
    jl = [float(s[0]) for s in run["jax"]["steps"]]
    tl = [float(s[0]) for s in run["port"]["steps"]]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    ja = [float(s[1]) for s in run["jax"]["steps"]]
    ta = [float(s[1]) for s in run["port"]["steps"]]
    assert ta == ja
    assert run["port"]["launches"] == {}              # the CPU runs plain


@pytest.mark.parametrize("opt", OPTS)
def test_the_update_ops_of_a_step_run_as_one_group(trained, opt):
    """The optimizer appends the 25 updates one after another, so the
    executor hands them to the group kernel as ONE run a step (one
    launch on the card), and the five steps above went through it."""
    run = trained(opt)
    assert run["port"]["runs"] == [25] * STEPS
    assert run["jax"]["runs"] == []


def test_op_runs_cut_at_another_op_attrs_and_a_read_after_write():
    """``op_runs``: consecutive updates of one type, attrs and slots
    form a run; another op between them, other attrs, other slots, an
    op that reads (or writes) what another op of the run writes, end
    it; an op's own in-place state (Param in, ParamOut out) does not;
    every other op is a run of one."""
    prog = ts.Program()
    blk = prog.global_block

    def upd(i, kind="momentum", mu=0.9, grad=None, found=False, lr="lr"):
        ins = {"Param": [f"p{i}"], "Grad": [grad or f"g{i}"],
               "Velocity": [f"v{i}"], "LearningRate": [lr]}
        if found:
            ins["FoundInfinite"] = ["found"]
        return blk.append_op(type=kind, inputs=ins,
                             outputs={"ParamOut": [f"p{i}"],
                                      "VelocityOut": [f"v{i}"]},
                             attrs={"mu": mu, "use_nesterov": False})

    upd(0)
    upd(1)
    upd(2)                                    # ops 0-2: one run
    blk.append_op(type="scale", inputs={"X": ["g3"]},
                  outputs={"Out": ["g3s"]}, attrs={"scale": 2.0})
    upd(3, grad="g3s")                        # op 4, after another op
    upd(4, mu=0.5)                            # op 5: other attrs
    upd(5, mu=0.5, found=True)                # op 6: other slots
    upd(6, mu=0.5, found=True)                # op 7 joins 6
    upd(7, mu=0.5, found=True, grad="p6")     # op 8 reads what 7 writes
    upd(8, mu=0.5, found=True, lr="p8")       # op 9 reads its own state
    upd(9, mu=0.5, found=True, lr="p7")       # op 10 reads what 8 writes
    upd(10, mu=0.5, found=True, lr="p11")     # op 11 joins 10 ...
    upd(11, mu=0.5, found=True)               # op 12 writes what 11 read
    upd(12, kind="sgd")                       # op 13: another update type
    runs = [[i for i, _ in run]
            for run in ts.op_runs(list(enumerate(blk.ops)))]
    assert runs == [[0, 1, 2], [3], [4], [5], [6, 7], [8, 9], [10, 11],
                    [12], [13]]
    assert ts.op_runs([]) == []


@pytest.mark.parametrize("opt", OPTS)
def test_every_persistable_matches_jax_after_five_steps(trained, opt):
    run = trained(opt)
    js_state, ts_state = run["jax"]["state"], run["port"]["state"]
    assert set(ts_state) == set(js_state)
    kinds = {"velocity", "moment1", "moment2", "beta1pow", "beta2pow"}
    seen = set()
    for name, want in js_state.items():
        got = ts_state[name]
        assert got.shape == want.shape and got.dtype == want.dtype, name
        _close(got, want, msg=name)
        seen |= {k for k in kinds if name.endswith(k)}
    want_kinds = {"momentum": {"velocity"}, "sgd": set()}.get(
        opt, {"moment1", "moment2", "beta1pow", "beta2pow"})
    assert seen == want_kinds
    # the running statistics moved off their initial 0 and 1
    assert not np.all(ts_state["batch_norm_w_2"] == 0.0)
    if opt in ("adam", "lamb"):
        np.testing.assert_array_equal(
            ts_state[f"conv2d_w_0_{opt}_beta1pow"],
            js_state[f"conv2d_w_0_{opt}_beta1pow"])


@pytest.mark.parametrize("opt", ("momentum", "adam"))
def test_step1_gradients_match_jax(trained, opt):
    run = trained(opt)
    names = run["grad_names"]
    assert len(names) == 25
    for name, g_j, g_t in zip(names, run["jax"]["steps"][0][2:],
                              run["port"]["steps"][0][2:]):
        assert g_t.shape == g_j.shape, name
        _close(g_t, g_j, msg=name)


def test_a_parameter_with_no_path_to_the_loss_gets_zeros():
    def prog(static, un):
        with un.guard():
            main, startup = static.Program(), static.Program()
            with static.program_guard(main, startup):
                x = static.data("x", [-1, 6])
                loss = static.mean(static.nn.fc(x, 3, act="relu"))
                static.create_parameter([4, 2], "float32")
                static.SGD(0.1).minimize(loss)
        return main, startup

    jm, jsu = prog(js, jun)
    tm, tsu = prog(ts, tun)
    assert tm.to_dict() == jm.to_dict()
    unused = "create_parameter_w_0@GRAD"
    x = np.random.RandomState(1).randn(5, 6).astype(np.float32)
    jscope, tscope = js.Scope(), ts.Scope()
    with js.scope_guard(jscope):
        jexe = js.Executor()
        jexe.run(jsu)
        init = {k: np.asarray(v) for k, v in jscope.items()}
        jg = jexe.run(jm, feed={"x": x},
                      fetch_list=[unused, "fc_w_0@GRAD"])
    ts.load_numpy_state(tscope, init, CPU)
    with ts.scope_guard(tscope):
        tg = ts.Executor(CPU).run(tm, feed={"x": x},
                                  fetch_list=[unused, "fc_w_0@GRAD"])
    np.testing.assert_array_equal(jg[0], np.zeros((4, 2), np.float32))
    np.testing.assert_array_equal(tg[0], np.zeros((4, 2), np.float32))
    _close(tg[1], jg[1])


# ---------------------------------------------------------------------------
# evaluation and inference models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt", ("momentum", "lamb"))
def test_test_mode_clone_logits_match_jax(trained, opt):
    run = trained(opt)
    assert run["port"]["eval"].shape == (BATCH, 10)
    _close(run["port"]["eval"], run["jax"]["eval"])


def _logits_of(static, model_dir, exe, x):
    scope = static.Scope()
    with static.scope_guard(scope):
        prog, feeds, fetches = static.load_inference_model(model_dir, exe)
        assert feeds == ["img"]
        return prog, exe.run(prog, feed={"img": x}, fetch_list=fetches)[0]


def test_inference_model_saved_by_jax_runs_in_the_port(trained, tmp_path):
    run = trained("momentum")
    jax_side = run["jax"]
    with js.scope_guard(jax_side["scope"]):
        js.save_inference_model(str(tmp_path), ["img"],
                                [jax_side["logits"]], jax_side["exe"],
                                jax_side["main"])
    prog, logits = _logits_of(ts, str(tmp_path), ts.Executor(CPU),
                              run["eval_batch"])
    assert not any(op.type in ("backward", "momentum")
                   for op in prog.global_block.ops)
    _close(logits, run["jax"]["eval"])


def test_inference_model_saved_by_the_port_runs_in_jax(trained, tmp_path):
    run = trained("momentum")
    port = run["port"]
    with ts.scope_guard(port["scope"]):
        ts.save_inference_model(str(tmp_path), ["img"], [port["logits"]],
                                port["exe"], port["main"])
    assert sorted(os.listdir(tmp_path)) == ["MANIFEST.json", "__model__",
                                            "params.pdparams"]
    with open(tmp_path / "params.pdparams", "rb") as f:
        assert all(isinstance(v, np.ndarray) for v in pickle.load(f).values())
    _, logits = _logits_of(js, str(tmp_path), js.Executor(),
                           run["eval_batch"])
    _close(logits, run["port"]["eval"])


def test_a_corrupt_saved_model_is_refused(trained, tmp_path):
    run = trained("momentum")
    port = run["port"]
    with ts.scope_guard(port["scope"]):
        ts.save_inference_model(str(tmp_path), ["img"], [port["logits"]],
                                port["exe"], port["main"])
    with open(tmp_path / "params.pdparams", "ab") as f:
        f.write(b"x")
    with pytest.raises(ValueError, match="truncated or corrupt"):
        ts.load_inference_model(str(tmp_path), ts.Executor(CPU))


def test_persistables_round_trip(trained, tmp_path):
    run = trained("adam")
    port = run["port"]
    with ts.scope_guard(port["scope"]):
        ts.save_persistables(port["exe"], str(tmp_path), port["main"])
    fresh = ts.Scope()
    with ts.scope_guard(fresh):
        ts.load_persistables(ts.Executor(CPU), str(tmp_path))
    assert set(fresh.keys()) == set(port["state"])
    for k, v in port["state"].items():
        np.testing.assert_array_equal(fresh.find_var(k).numpy(), v)


# ---------------------------------------------------------------------------
# what this slice refuses
# ---------------------------------------------------------------------------
def test_executor_without_a_place_runs_on_cuda_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.Executor()


def test_options_outside_this_slice_raise():
    with tun.guard():
        main, startup = ts.Program(), ts.Program()
        with ts.program_guard(main, startup):
            x = ts.data("x", [-1, 4])
            loss = ts.mean(ts.nn.fc(x, 2))
            with pytest.raises(NotImplementedError, match="later port"):
                ts.append_backward(loss, checkpoints=[x])
            with pytest.raises(NotImplementedError, match="later port"):
                ts.SGD(0.1, grad_clip=object())
            with pytest.raises(NotImplementedError, match="later port"):
                ts.set_gradient_clip(object())
