"""The small ResNet of ``tests/test_torch_resnet.py`` at AMP O2 fp16
(``amp.decorate``, Momentum with ``multi_precision`` and
``weight_decay=L2Decay(1e-4)``, the fp16 ResNet-50 recipe) held against
the JAX package on the CPU.

BottleneckBlock ``[1, 1, 1, 1]``, 10 classes, batch 4 x 3 x 64 x 64,
Momentum lr 1e-3 mu 0.9, both models built under ``unique_name.guard()``
with the JAX weights carried across, then ``decorate(level="O2",
dtype="float16")`` on each side.

- Three ``TrainStep`` losses against JAX's, rtol 2e-2 (measured on one
  machine's CPU: 2.3617 / 2.3633, 0.9242 / 0.9214, 0.1283 / 0.1282, a
  gap of at most 3.0e-3: the fp16 convolutions and batch norms round in
  other places). The loss is f32 (``softmax_with_cross_entropy`` is
  black-listed) on both sides.
- The dtype flow equals JAX's: convolution, batch norm, every block and
  the logits fp16; the running statistics fp16 (``decorate`` casts
  floating buffers).
- The masters are the pre-decorate weights bit for bit; after every step
  each fp16 parameter equals its master's cast.
- ``state_dict()`` keys equal JAX's; a round trip through
  ``set_state_dict`` restores every slot bit for bit; JAX's model and
  optimizer state after three steps, carried into a fresh decorated
  port model by ``load_numpy_state(..., optimizer, optimizer_state)``,
  give a fourth step whose loss matches JAX's.
- The eager ``GradScaler`` loop (``scaler.scale(loss).backward();
  scaler.minimize(opt, scaled); opt.clear_grad()``) at scale 128 trains
  like JAX's ``TrainStep`` (rtol 2e-2; JAX's eager tape cannot run this
  loop, ``framework/tape.py:164``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.utils import unique_name as jun
from paddle_tpu_torch import amp, nn, regularizer
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.utils import unique_name as tun
from paddle_tpu_torch.vision import models as tvm
from test_torch_resnet import LR, MU, _batch, _small

STEPS = 3


def _jopt(m):
    return jopt.Momentum(learning_rate=LR, momentum=MU,
                         parameters=m.parameters(),
                         weight_decay=jreg.L2Decay(1e-4),
                         multi_precision=True)


def _topt(m):
    return Momentum(learning_rate=LR, momentum=MU, parameters=m.parameters(),
                    weight_decay=regularizer.L2Decay(1e-4),
                    multi_precision=True)


def _decorated(state=None):
    paddle.seed(0)
    with jun.guard():
        jm = _small(True)
    with tun.guard():
        tm = _small(False)
    tvm.load_numpy_state(tm, state or {k: v.numpy()
                                       for k, v in jm.state_dict().items()})
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    jo, to = _jopt(jm), _topt(tm)
    jamp.decorate(jm, jo, level="O2", dtype="float16")
    amp.decorate(tm, to, level="O2", dtype="float16")
    return jm, tm, jo, to, before


def _jloss(m, x, y):
    with jamp.auto_cast(level="O2", dtype="float16"):
        return jnn.CrossEntropyLoss()(m(x), y)


def _tloss(m, x, y):
    with amp.auto_cast(level="O2", dtype="float16"):
        return nn.CrossEntropyLoss()(m(x), y)


def _args():
    x, y = _batch()
    return ((paddle.to_tensor(x), paddle.to_tensor(y)),
            (torch.from_numpy(x), torch.from_numpy(y)))


def _np_state(state):
    return {k: (v if isinstance(v, (int, dict)) else v.numpy())
            for k, v in state.items()}


@pytest.fixture(scope="module")
def jax_run():
    """JAX's side once: the losses of four TrainStep steps, and its
    model and optimizer state (numpy) after the third."""
    jm, _, jo, _, _ = _decorated()
    jstep = JTrainStep(jm, _jloss, jo)
    jargs, _ = _args()
    losses = [float(jstep(*jargs).numpy()) for _ in range(STEPS)]
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    opt_state = _np_state(jo.state_dict())
    losses.append(float(jstep(*jargs).numpy()))
    return losses, state, opt_state


def test_o2_fp16_steps_match_jax_and_carry_state_across(jax_run):
    jl, jstate, js = jax_run
    _, tm, _, to, before = _decorated()
    for n, p in tm.named_parameters():
        assert torch.equal(to._slots[id(p)]["__master__"], before[n]), n
    tstep = TrainStep(tm, _tloss, to)
    _, targs = _args()
    tl = []
    for _ in range(STEPS):
        t = tstep(*targs)
        assert t.dtype == torch.float32
        tl.append(float(t))
        for n, p in tm.named_parameters():
            assert p.dtype == torch.float16
            assert torch.equal(p, to._slots[id(p)]["__master__"].to(
                torch.float16)), n
    np.testing.assert_allclose(tl, jl[:STEPS], rtol=2e-2)
    assert tl[-1] < tl[0]
    ts = to.state_dict()
    assert set(ts) == set(js) and ts["step"] == js["step"] == STEPS
    # a round trip restores every slot bit for bit
    _, tm2, _, to2, _ = _decorated()
    to2.set_state_dict(ts)
    assert to2._step_count == STEPS
    p2 = dict(tm2.named_parameters())
    for n, p in tm.named_parameters():
        a, b = to._slots[id(p)], to2._slots[id(p2[n])]
        assert set(a) == set(b)
        assert all(torch.equal(a[k], b[k]) for k in a)
    # JAX's state after three steps carried into a fresh port model: the
    # masters arrive bit for bit and the fourth step's losses agree
    _, tm3, _, to3, _ = _decorated()
    tvm.load_numpy_state(tm3, jstate, to3, js)
    for p in tm3.parameters():
        np.testing.assert_array_equal(
            to3._slots[id(p)]["__master__"].numpy(),
            js[f"{p.name}@__master__"])
    t4 = float(TrainStep(tm3, _tloss, to3)(*targs))
    np.testing.assert_allclose(t4, jl[STEPS], rtol=2e-2)


def test_o2_fp16_dtype_flow_matches_jax():
    jm, tm, _, _, _ = _decorated()
    jargs, targs = _args()

    def name(t):
        return str(t.dtype).replace("torch.", "")

    flows = []
    for m, (x, y), ac, ce in ((jm, jargs, jamp, jnn), (tm, targs, amp, nn)):
        with ac.auto_cast(level="O2", dtype="float16"):
            c = m.conv1(x)
            b = m.bn1(c)
            h = m.maxpool(m.relu(b))
            blocks = []
            for stage in (m.layer1, m.layer2, m.layer3, m.layer4):
                h = stage(h)
                blocks.append(name(h))
            logits = m(x)
            loss = ce.CrossEntropyLoss()(logits, y)
        flows.append([name(c), name(b)] + blocks
                     + [name(logits), name(loss), name(m.bn1._mean),
                        name(m.bn1._variance)])
    assert flows[1] == flows[0]
    assert flows[1] == ["float16"] * 7 + ["float32", "float16", "float16"]


def test_grad_scaler_eager_loop_trains_like_jax(jax_run):
    _, tm, _, to, _ = _decorated()
    _, (tx, ty) = _args()
    scaler = amp.GradScaler(init_loss_scaling=128.0)
    tm.train()
    tl = []
    for _ in range(STEPS):
        loss = _tloss(tm, tx, ty)
        scaled = scaler.scale(loss)
        scaled.backward()
        scaler.minimize(to, scaled)
        to.clear_grad()
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jax_run[0][:STEPS], rtol=2e-2)
    assert to._step_count == STEPS and scaler.get_loss_scaling() == 128.0
