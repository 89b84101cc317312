"""The port's vision training path (paddle_tpu_torch: vision.models, nn
conv / batch norm / pooling, optimizer.Momentum, jit.TrainStep) held
against the JAX package on the CPU.

A small ResNet (BottleneckBlock ``[1, 1, 1, 1]``, 10 classes), batch 4
x 3 x 64 x 64, Momentum mu 0.9 as ``bench.py`` ``bench_resnet`` trains
ResNet-50, but at lr 1e-3 instead of 0.1: on four images one lr-0.1
step memorises the batch (the loss falls from 2.36 to 0.63, then to
7e-4), and the losses after such a step are chaotic in the last bits
of the first one (under O1 the JAX side alone gave 0.779 and 0.792 for
its second loss in two processes). At lr 1e-3 the three losses fall
2.36, 0.92, 0.13. The JAX model is built from ``paddle_tpu.seed(0)``
and its ``state_dict()`` (parameters and the batch norms' running
buffers) is carried into the port by name (``load_numpy_state``); the
batch is numpy. On the CPU the port's Momentum kernel runs its plain
version and the JAX side its XLA rule.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.vision import models as jvm
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as tvm

B, S, CLASSES = 4, 64, 10
LR, MU = 1e-3, 0.9


def _small(jax_side):
    if jax_side:
        return jvm.ResNet(jvm.BottleneckBlock, [1, 1, 1, 1],
                          num_classes=CLASSES)
    return tvm.ResNet(tvm.BottleneckBlock, [1, 1, 1, 1], num_classes=CLASSES,
                      device="cpu")


def _models():
    paddle.seed(0)
    jm = _small(True)
    tm = _small(False)
    tvm.load_numpy_state(tm, {k: v.numpy()
                              for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 3, S, S).astype(np.float32),
            rng.randint(0, CLASSES, (B,)).astype(np.int64))


def _train(level, n, nesterov=False):
    """n TrainStep calls on both sides from the same weights and batch;
    returns (JAX losses, port losses, JAX model, port model, velocities
    after step 1 as {name: (JAX, port)}). A velocity starts at zero, so
    after step 1 it is exactly that step's gradient (mu*0 + g = g)."""
    jm, tm = _models()
    jce, tce = jnn.CrossEntropyLoss(), nn.CrossEntropyLoss()

    def jloss(m, x, y):
        with jamp.auto_cast(level=level, dtype="bfloat16"):
            return jce(m(x), y)

    def tloss(m, x, y):
        with amp.auto_cast(level=level, dtype="bfloat16"):
            return tce(m(x), y)

    jo = jopt.Momentum(learning_rate=LR, momentum=MU, use_nesterov=nesterov,
                       parameters=jm.parameters())
    to = Momentum(learning_rate=LR, momentum=MU, use_nesterov=nesterov,
                  parameters=tm.parameters())
    jstep, tstep = JTrainStep(jm, jloss, jo), TrainStep(tm, tloss, to)
    x, y = _batch()
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jl, tl, vel = [], [], {}
    for i in range(n):
        jl.append(float(jstep(jx, jy).numpy()))
        tl.append(float(tstep(tx, ty)))
        if i == 0:
            tp = dict(tm.named_parameters())
            vel = {name: (np.asarray(jo._slots[id(p)]["velocity"]),
                          to._slots[id(tp[name])]["velocity"].numpy().copy())
                   for name, p in jm.named_parameters()}
    return np.array(jl), np.array(tl), jm, tm, vel


@pytest.fixture(scope="module")
def o0_three_steps():
    return _train("O0", 3)


@pytest.fixture(scope="module")
def o0_steps_from_equal_state():
    """Three O0 steps on JAX's trajectory. Before each JAX step its whole
    state (parameters, running ``_mean``/``_variance``, velocities) is
    carried into the port, which takes the same step from it; returns
    ([(JAX buffers, port buffers) after each step], JAX model, port
    model). Free-running trajectories cannot be held to f32 tolerances
    past step 1: at this batch a ReLU input lies within f32 rounding of
    zero (at the state after step 2, element (0, 14, 3, 7) of
    ``layer2.0``'s first ReLU is 7.2e-7 in the port's f32 forward and
    -1.4e-6 in its f64 forward), so which side of the kink each
    framework's summation order lands on moves one channel's gradient by
    up to 14 % of the tensor's largest value. Measured on one machine's
    CPU: from JAX's state after step 1 JAX's f32 gradient is 9.2e-2 from
    the port's f64 gradient in ``layer4.0.conv3.weight`` while the port's
    f32 gradient is 6.4e-6 from it; from the state after step 2 it is the
    port's f32 that is 1.4e-1 from f64 in ``layer2.0.conv1.weight`` and
    JAX's 6.4e-6. Neither update rule is at fault, and the batch norm
    statistics a step writes come from its forward, which has no kink."""
    jm, tm = _models()
    jce, tce = jnn.CrossEntropyLoss(), nn.CrossEntropyLoss()
    jo = jopt.Momentum(learning_rate=LR, momentum=MU,
                       parameters=jm.parameters())
    to = Momentum(learning_rate=LR, momentum=MU, parameters=tm.parameters())
    jstep = JTrainStep(jm, lambda m, x, y: jce(m(x), y), jo)
    tstep = TrainStep(tm, lambda m, x, y: tce(m(x), y), to)
    x, y = _batch()
    tp = dict(tm.named_parameters())
    after = []
    for i in range(3):
        tvm.load_numpy_state(tm, {k: v.numpy()
                                  for k, v in jm.state_dict().items()})
        for name, p in jm.named_parameters():
            if i:
                to._slot(tp[name])["velocity"].copy_(torch.from_numpy(
                    np.array(jo._slots[id(p)]["velocity"])))
        jstep(paddle.to_tensor(x), paddle.to_tensor(y))
        tstep(torch.from_numpy(x), torch.from_numpy(y))
        after.append(({k: v.numpy().copy()
                       for k, v in jm.state_dict().items()},
                      {k: v.numpy().copy() for k, v in tm.named_buffers()}))
    return after, jm, tm


def test_state_dict_keys_and_shapes_match_the_jax_model():
    """Parameters and the ``_mean``/``_variance`` buffers, one to one;
    and the port's ResNet-50 has ResNet-50's 161 parameter tensors of
    25,557,032 elements and 53 batch norms."""
    jm, tm = _models()
    js = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    ts = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert js == ts
    assert len(ts) == 53 + 2 * 17
    r50 = tvm.resnet50(device="cpu")
    assert len(list(r50.parameters())) == 161
    assert sum(p.numel() for p in r50.parameters()) == 25557032
    bufs = {n for n, _ in r50.named_buffers()}
    assert len(bufs) == 2 * 53
    assert bufs == {k for k in r50.state_dict()
                    if k.endswith(("._mean", "._variance"))}


def test_o0_three_momentum_steps_match_jax(o0_three_steps):
    """f32 throughout: the two sides differ only in summation order, so
    the losses of three Momentum steps agree to rtol 1e-4."""
    jl, tl, _, _, _ = o0_three_steps
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_o0_running_statistics_match_jax(o0_steps_from_equal_state):
    """Every batch norm's ``_mean`` and ``_variance`` after each of three
    train steps taken from JAX's state (the fixture says why not from
    the port's own), within rtol 1e-5: the BIASED variance and Paddle's
    momentum, as the JAX package updates them, three times over, so the
    old value's weight compounds. PyTorch's unbiased running variance
    would be off by a factor 16/15 at layer4's 2 x 2 x 4 values a
    channel. A channel mean near zero carries the absolute error of its
    neighbours, so the floor is 1e-5 of the buffer's largest value; the
    largest error measured is 1.8e-6 of it (after step 1)."""
    after, _, _ = o0_steps_from_equal_state
    for jb, tb in after:
        assert set(tb) == {k for k in jb
                           if k.endswith(("._mean", "._variance"))}
        assert len(tb) == 2 * 17
        for name, got in tb.items():
            want = jb[name]
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=name)
    assert not np.allclose(after[-1][0]["layer4.0.bn2._variance"], 1.0)


def test_o0_eval_forward_after_training_matches_jax(
        o0_steps_from_equal_state):
    """Eval mode normalises with the running buffers: from JAX's state
    after three train steps (parameters and buffers), the logits of a
    fresh batch agree within atol 1e-5 times the largest logit (which is
    9.0; the largest error measured is 1.06e-6 of it, where a forward
    with the batch's statistics instead of the buffers is 1.07 times it
    off), and an eval forward leaves the buffers as they were."""
    _, jm, tm = o0_steps_from_equal_state
    tvm.load_numpy_state(tm, {k: v.numpy()
                              for k, v in jm.state_dict().items()})
    x, _ = _batch(seed=1)
    jm.eval()
    tm.eval()
    want = jm(paddle.to_tensor(x)).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        tm(torch.from_numpy(x))
    assert all(torch.equal(v, tm.state_dict()[k]) for k, v in before.items())


def test_o0_step_one_gradients_match_jax(o0_three_steps):
    """Every gradient of the first step's loss at the carried-over
    weights, read as the velocity after step 1, within atol 1e-5 + rtol
    1e-4 (f32; summation order only)."""
    _, _, jm, _, vel = o0_three_steps
    assert set(vel) == {n for n, _ in jm.named_parameters()}
    for name, (want, got) in vel.items():
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4,
                                   err_msg=name)


def test_o1_bf16_two_steps_match_jax():
    """AMP O1: the convolutions and the head run in bf16; batch norm
    normalises the bf16 conv output in bf16 and its f32 scale makes its
    output f32, so ReLU, the residual adds and the pooling run in f32,
    as in JAX. bf16 keeps ~3 significant digits and the two frameworks
    round the conv sums and the bf16 normalisation at different places,
    so the losses of two steps
    agree to rtol 2e-2 (measured: 8.9e-4 and 3.6e-3)."""
    jl, tl, _, _, _ = _train("O1", 2)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)


def test_o1_dtype_flow_follows_jax():
    """Under O1 the port's conv output is bf16 and batch norm's output
    f32 (bf16 statistics times the f32 scale), and the running buffers
    stay f32."""
    _, tm = _models()
    x = torch.from_numpy(_batch()[0])
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        c = tm.conv1(x)
        b = tm.bn1(c)
        logits = tm(x)
    assert c.dtype == torch.bfloat16
    assert b.dtype == torch.float32
    assert logits.dtype == torch.bfloat16
    assert tm.bn1._mean.dtype == tm.bn1._variance.dtype == torch.float32


@pytest.mark.parametrize("nesterov,wd", [(True, None), (True, 1e-4),
                                         (False, 1e-4)],
                         ids=["nesterov", "nesterov-l2", "l2"])
def test_momentum_steps_match_the_jax_optimizer(nesterov, wd):
    """Three Momentum steps (Nesterov or not, with and without a float
    weight_decay, the coupled L2 term) over a mixed parameter list:
    parameters and velocities against JAX's ``apply_gradients_fn``,
    rtol 1e-6 with a floor of 1e-6 of the largest value (XLA may fuse
    ``mu*v + g`` into one FMA where the port rounds the product)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    ps = {"w": rng.randn(64, 3, 3, 3).astype(np.float32),
          "b": rng.randn(64).astype(np.float32)}
    gs = [{k: rng.randn(*x.shape).astype(np.float32) * 0.1
           for k, x in ps.items()} for _ in range(3)]
    jo = jopt.Momentum(learning_rate=0.1, momentum=MU, use_nesterov=nesterov,
                       weight_decay=wd, parameters=[])
    jp = {k: jnp.asarray(x) for k, x in ps.items()}
    state = jo.init_state(jp)
    tps = {k: torch.nn.Parameter(torch.from_numpy(x.copy()))
           for k, x in ps.items()}
    to = Momentum(learning_rate=0.1, momentum=MU, use_nesterov=nesterov,
                  weight_decay=wd, parameters=list(tps.values()))
    for g in gs:
        jp, state = jo.apply_gradients_fn(
            {k: jnp.asarray(x) for k, x in g.items()}, jp, state, 0.1)
        for k, t in tps.items():
            t.grad = torch.from_numpy(g[k])
        to.step()
    for k, t in tps.items():
        for got, want in ((t.detach(), jp[k]),
                          (to._slots[id(t)]["velocity"],
                           state["slots"][k]["velocity"])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())


def test_batch_norm_functional_matches_jax():
    """``F.batch_norm`` alone in train mode, f32 and bf16 input: output,
    running mean and running variance. For the bf16 input the running
    statistics agree bit for bit and the output to one bf16 ulp (1e-2):
    XLA's CPU backend may keep an intermediate in f32 where the port
    rounds each bf16 step, as JAX's code reads. And the pooling ops
    against
    theirs (max pool with padding and ceil_mode, adaptive average pool
    with an output size that does not divide the input)."""
    from paddle_tpu.nn import functional as JF
    from paddle_tpu.ops.manipulation import flatten as jflatten
    from paddle_tpu_torch.nn import functional as F

    rng = np.random.RandomState(7)
    x = (rng.randn(3, 5, 6, 7) * 2 + 1).astype(np.float32)
    w = rng.rand(5).astype(np.float32) + 0.5
    b = rng.randn(5).astype(np.float32)
    for dt, tol in ((np.float32, 1e-6), ("bfloat16", 1e-2)):
        jx = paddle.to_tensor(x).astype(dt)
        tx = torch.from_numpy(x).to(torch.float32 if dt == np.float32
                                    else torch.bfloat16)
        jrm, jrv = paddle.to_tensor(np.zeros(5, np.float32)), \
            paddle.to_tensor(np.ones(5, np.float32))
        trm, trv = torch.zeros(5), torch.ones(5)
        jo = JF.batch_norm(jx, jrm, jrv, paddle.to_tensor(w),
                           paddle.to_tensor(b), training=True)
        to = F.batch_norm(tx, trm, trv, torch.from_numpy(w),
                          torch.from_numpy(b), training=True)
        assert to.dtype == torch.float32
        np.testing.assert_allclose(to.numpy(), np.asarray(jo.numpy(),
                                                          np.float32),
                                   atol=tol, rtol=tol)
        np.testing.assert_allclose(trm.numpy(), jrm.numpy(), rtol=tol,
                                   atol=1e-7)
        np.testing.assert_allclose(trv.numpy(), jrv.numpy(), rtol=tol)
    jx, tx = paddle.to_tensor(x), torch.from_numpy(x)
    for k, s, p, ceil in ((3, 2, 1, False), (2, 2, 0, True), (3, 2, 1, True)):
        np.testing.assert_array_equal(
            F.max_pool2d(tx, k, s, p, ceil_mode=ceil).numpy(),
            JF.max_pool2d(jx, k, s, p, ceil_mode=ceil).numpy())
    for o in (1, (2, 3), (4, 5)):
        np.testing.assert_allclose(F.adaptive_avg_pool2d(tx, o).numpy(),
                                   JF.adaptive_avg_pool2d(jx, o).numpy(),
                                   atol=1e-6)
    assert tuple(F.flatten(tx, 1).shape) == \
        tuple(jflatten(jx, 1).shape) == (3, 210)


def test_load_numpy_state_refuses_missing_extra_and_misshapen_keys():
    tm = _small(False)
    state = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    tvm.load_numpy_state(tm, state)
    missing = dict(state)
    missing.pop("layer1.0.bn1._variance")
    with pytest.raises(KeyError, match="_variance"):
        tvm.load_numpy_state(tm, missing)
    with pytest.raises(KeyError, match="extra"):
        tvm.load_numpy_state(tm, {**state, "bn1.num_batches_tracked":
                                  np.zeros((), np.int64)})
    bad = dict(state)
    bad["conv1.weight"] = bad["conv1.weight"].transpose(1, 0, 2, 3)
    with pytest.raises(ValueError, match="conv1.weight"):
        tvm.load_numpy_state(tm, bad)


def test_vision_entry_points_need_a_device_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("the card is present: device=None builds on it")
    for build in (tvm.resnet50, tvm.LeNet):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_layers_refuse_what_is_not_ported():
    """What the layers still refuse: a bad layout, a bad padding string,
    a channel count the weight cannot take. The padding modes, label
    smoothing and NHWC, refused before they were ported, now compute
    (held against JAX in ``test_torch_nn_formats.py``): a reflect-mode
    conv pads with zeros, as the JAX layer does."""
    torch.manual_seed(0)
    zeros = nn.Conv2D(3, 4, 3, padding=1, device="cpu")
    reflect = nn.Conv2D(3, 4, 3, padding=1, padding_mode="reflect",
                        device="cpu")
    reflect.load_state_dict(zeros.state_dict())
    x = torch.randn(1, 3, 5, 5)
    assert torch.equal(reflect(x), zeros(x))
    assert float(nn.CrossEntropyLoss(label_smoothing=0.1)(
        torch.randn(4, 5), torch.tensor([0, 1, 2, 3]))) > 0
    with pytest.raises(ValueError, match="data_format"):
        nn.functional.conv2d(torch.zeros(1, 2, 4, 4), torch.zeros(3, 2, 1, 1),
                             data_format="NDHWC")
    with pytest.raises(ValueError, match="padding"):
        nn.functional.max_pool2d(torch.zeros(1, 2, 4, 4), 2, padding="FULL")
    with pytest.raises(ValueError, match="C_in"):
        nn.functional.conv2d(torch.zeros(1, 2, 4, 4), torch.zeros(3, 4, 1, 1))
