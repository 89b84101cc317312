"""Regularizer objects in the port's dygraph optimizers, held against the
JAX package on the CPU: the cases of ``tests/test_regularizer.py`` run
through both packages from the same weights and inputs.

- L2/L1 decay on SGD against the manual update and against JAX's step;
- ``ParamAttr.regularizer`` over the optimizer's (the weight takes its
  own L1, the bias the optimizer's L2);
- a float ``weight_decay`` (L2 of it) unchanged;
- an object on ``AdamW`` degrading to its ``coeff``, decoupled;
- a per-parameter regularizer through ``TrainStep``;
- Momentum and Adam with an ``L2Decay`` object and per-parameter L1,
  against JAX's ``apply_gradients_fn`` with the Pallas kernels in
  interpret mode (``PADDLE_FUSED_OPT_INTERPRET=1``);
- ``ParamAttr`` objects on ``Conv2D`` and ``BatchNorm2D``.

Tolerances: the port and JAX run the same f32 operations; the updates
agree to rtol 1e-6 (XLA may fuse a product and a sum into one FMA), and
to the manual formula at the JAX test's rtol 1e-5.
"""
import functools

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu import regularizer as jreg
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu_torch import nn, optimizer, regularizer
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn.layer import load_numpy_state

X = np.ones((2, 4), np.float32)


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setenv("PADDLE_FUSED_OPT_INTERPRET", "1")


def _pair(jreg_obj=None, treg_obj=None):
    """The JAX test's Linear(4, 3) (weight regularizer optional) and the
    port's with the same weights."""
    paddle.seed(0)
    jl = jnn.Linear(4, 3, weight_attr=jnn.ParamAttr(regularizer=jreg_obj)
                    if jreg_obj else None)
    tl = nn.Linear(4, 3, weight_attr=nn.ParamAttr(regularizer=treg_obj)
                   if treg_obj else None, device="cpu")
    load_numpy_state(tl, {k: v.numpy() for k, v in jl.state_dict().items()})
    return jl, tl


def _sum_step(jl, tl, jo, to):
    loss = jl(paddle.to_tensor(X)).sum()
    loss.backward()
    jo.step()
    tl(torch.from_numpy(X)).sum().backward()
    to.step()


def _assert_same(jl, tl, rtol=1e-6):
    for name, p in jl.named_parameters():
        got = dict(tl.named_parameters())[name].detach().numpy()
        np.testing.assert_allclose(got, p.numpy(), rtol=rtol, atol=1e-7,
                                   err_msg=name)


@pytest.mark.parametrize("kind", ["l2", "l1"])
def test_decay_matches_manual_and_jax(kind):
    coeff = 0.5 if kind == "l2" else 0.3
    jcls = jreg.L2Decay if kind == "l2" else jreg.L1Decay
    tcls = regularizer.L2Decay if kind == "l2" else regularizer.L1Decay
    jl, tl = _pair()
    w0 = tl.weight.detach().numpy().copy()
    jo = jopt.SGD(learning_rate=0.1, parameters=jl.parameters(),
                  weight_decay=jcls(coeff))
    to = optimizer.SGD(learning_rate=0.1, parameters=tl.parameters(),
                       weight_decay=tcls(coeff))
    _sum_step(jl, tl, jo, to)
    g = np.ones((4, 3), np.float32) * X.sum(0)[:, None]
    term = w0 if kind == "l2" else np.sign(w0)
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               w0 - 0.1 * (g + coeff * term), rtol=1e-5)
    _assert_same(jl, tl)


def test_param_attr_overrides_the_optimizer_regularizer():
    jl, tl = _pair(jreg.L1Decay(1.0), regularizer.L1Decay(1.0))
    w0 = tl.weight.detach().numpy().copy()
    b0 = tl.bias.detach().numpy().copy()
    jo = jopt.SGD(learning_rate=0.1, parameters=jl.parameters(),
                  weight_decay=jreg.L2Decay(0.5))
    to = optimizer.SGD(learning_rate=0.1, parameters=tl.parameters(),
                       weight_decay=regularizer.L2Decay(0.5))
    _sum_step(jl, tl, jo, to)
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               w0 - 0.1 * (2.0 + 1.0 * np.sign(w0)),
                               rtol=1e-5)
    np.testing.assert_allclose(tl.bias.detach().numpy(),
                               b0 - 0.1 * (2.0 + 0.5 * b0), rtol=1e-5)
    _assert_same(jl, tl)


def test_float_weight_decay_unchanged():
    jl, tl = _pair()
    w0 = tl.weight.detach().numpy().copy()
    jo = jopt.SGD(learning_rate=0.1, parameters=jl.parameters(),
                  weight_decay=0.5)
    to = optimizer.SGD(learning_rate=0.1, parameters=tl.parameters(),
                       weight_decay=0.5)
    _sum_step(jl, tl, jo, to)
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               w0 - 0.1 * (2.0 + 0.5 * w0), rtol=1e-5)
    _assert_same(jl, tl)


def test_adamw_decouples_a_regularizer_object():
    """AdamW takes an ``L2Decay`` as its coefficient, decoupled: the
    same update as the float 0.1, and JAX's."""
    jl, tl = _pair()
    w0 = tl.weight.detach().numpy().copy()
    jo = jopt.AdamW(learning_rate=0.1, parameters=jl.parameters(),
                    weight_decay=jreg.L2Decay(0.1))
    to = optimizer.AdamW(learning_rate=0.1, parameters=tl.parameters(),
                         weight_decay=regularizer.L2Decay(0.1))
    assert to._l2_coeff == 0.1 and to._default_regularizer() is None
    _sum_step(jl, tl, jo, to)
    assert not np.allclose(tl.weight.detach().numpy(), w0)
    _assert_same(jl, tl)
    _, tf = _pair()
    fo = optimizer.AdamW(learning_rate=0.1, parameters=tf.parameters(),
                         weight_decay=0.1)
    tf(torch.from_numpy(X)).sum().backward()
    fo.step()
    assert torch.equal(tf.weight, tl.weight)


def test_per_parameter_regularizer_through_trainstep():
    jl, tl = _pair(jreg.L2Decay(0.5), regularizer.L2Decay(0.5))
    w0 = tl.weight.detach().numpy().copy()
    y = np.zeros((2, 3), np.float32)
    jstep = JTrainStep(jl, lambda m, x, t: ((m(x) - t) ** 2).mean(),
                       jopt.SGD(learning_rate=0.1,
                                parameters=jl.parameters()))
    tstep = TrainStep(tl, lambda m, x, t: ((m(x) - t) ** 2).mean(),
                      optimizer.SGD(learning_rate=0.1,
                                    parameters=tl.parameters()))
    jstep(paddle.to_tensor(X), paddle.to_tensor(y))
    tstep(torch.from_numpy(X), torch.from_numpy(y))
    out = X @ w0
    g_w = X.T @ (2 * out / out.size)
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               w0 - 0.1 * (g_w + 0.5 * w0), rtol=1e-4,
                               atol=1e-6)
    _assert_same(jl, tl)


@pytest.mark.parametrize("rule", ["momentum", "adam"])
def test_rules_with_regularizer_objects_match_apply_gradients(rule):
    """Two parameters (one above the JAX kernel's 1024-element gate):
    the optimizer's ``L2Decay(1e-3)`` and one parameter's own
    ``L1Decay(1e-2)``; two steps against ``apply_gradients_fn``."""
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    ps = {"w": rng.randn(40, 64).astype(np.float32),
          "b": rng.randn(64).astype(np.float32)}
    kw = dict(learning_rate=1e-2)
    if rule == "momentum":
        jo = jopt.Momentum(momentum=0.9, parameters=[],
                           weight_decay=jreg.L2Decay(1e-3), **kw)
        to_cls = functools.partial(optimizer.Momentum, momentum=0.9)
    else:
        jo = jopt.Adam(parameters=[], weight_decay=jreg.L2Decay(1e-3), **kw)
        to_cls = optimizer.Adam
    jo._set_regs({"b": jreg.L1Decay(1e-2)})
    tps = {k: torch.nn.Parameter(torch.from_numpy(x.copy()))
           for k, x in ps.items()}
    tps["b"].regularizer = regularizer.L1Decay(1e-2)
    to = to_cls(parameters=list(tps.values()),
                weight_decay=regularizer.L2Decay(1e-3), **kw)
    jp = {k: jnp.asarray(x) for k, x in ps.items()}
    state = jo.init_state(jp)
    for _ in range(2):
        gs = {k: (rng.randn(*x.shape) * 0.1).astype(np.float32)
              for k, x in ps.items()}
        jp, state = jo.apply_gradients_fn(
            {k: jnp.asarray(g) for k, g in gs.items()}, jp, state, 1e-2)
        for k, t in tps.items():
            t.grad = torch.from_numpy(gs[k])
        to.step()
    for k in ps:
        want = np.asarray(jp[k])
        np.testing.assert_allclose(tps[k].detach().numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=k)


def test_param_attrs_on_conv_and_batch_norm():
    """``Conv2D``/``BatchNorm2D`` take ``ParamAttr`` objects, names and
    initializers (no raise), keep the regularizer and trainable flag,
    and ``bias_attr=False`` drops the parameter as before."""
    from paddle_tpu_torch.nn import initializer as I

    reg = regularizer.L2Decay(1e-4)
    conv = nn.Conv2D(3, 4, 3, weight_attr=nn.ParamAttr(
        name="conv_w", regularizer=reg, initializer=I.Constant(0.5)),
        bias_attr="conv_b", device="cpu")
    assert conv.weight.name == "conv_w" and conv.weight.regularizer is reg
    assert torch.equal(conv.weight, torch.full((4, 3, 3, 3), 0.5))
    assert conv.bias.name == "conv_b"
    bn = nn.BatchNorm2D(4, weight_attr=nn.ParamAttr(trainable=False),
                        bias_attr=I.Constant(0.25), device="cpu")
    assert not bn.weight.requires_grad and bn.weight.trainable is False
    assert torch.equal(bn.bias, torch.full((4,), 0.25))
    assert nn.Conv2D(3, 4, 1, bias_attr=False, device="cpu").bias is None
    assert nn.BatchNorm2D(4, weight_attr=False, device="cpu").weight is None
    opt = optimizer.Momentum(learning_rate=0.1,
                             parameters=list(conv.parameters()))
    assert opt._regularizers([conv.weight, conv.bias]) == [reg, None]
