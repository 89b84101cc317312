"""The eight update rules JAX runs in XLA only (``Adamax``, ``Adagrad``,
``DecayedAdagrad``, ``Adadelta``, ``RMSProp``, ``Ftrl``, ``LarsMomentum``,
``Dpsgd``; ``paddle_tpu/optimizer/optimizer.py:340-535``) held against
the JAX package's ``apply_gradients_fn`` on the CPU.

Each rule takes two steps from the same numpy parameters and gradients,
with an L2 regularizer (``weight_decay=1e-3``, where the rule takes one)
and ``ClipGradByGlobalNorm(0.05)`` (every rule but Dpsgd, which takes
neither), parametrised over the parameters' form:

- f32: parameters and slots within rtol 2e-6 of each tensor's largest
  value (XLA and PyTorch sum a norm in other orders, and XLA may fuse an
  f32 chain differently; measured on one machine's CPU: most tensors
  bit for bit, the largest difference a few f32 units);
- bf16 with f32 masters (``multi_precision=True``), each parameter its
  master's cast bit for bit: without the regularizer and clip the
  masters and slots as f32; with them within 8e-3 of each tensor's
  largest value, since the port rounds the regularized and clipped
  gradient to bf16 before the upcast (JAX's rule, and the kernels'
  master forms) while XLA on the CPU drops that rounding (a bf16 result
  cast straight to f32 keeps its f32 value: excess precision), a
  difference of half a bf16 unit (2^-9) of each gradient, 2^-8 in a
  squared gradient's slot;
- bf16 without masters: parameters and slots within two bf16 units of
  the element (a norm's sum order or a pow may move a rounding) plus
  1e-6 of the tensor's largest value.

``Dpsgd`` at ``sigma=0`` is exact against JAX; with ``sigma=1`` its
noise (threefry's bits are not reproduced) is held by its moments over
2^20 draws: mean within 5 standard errors of 0, deviation within 1 % of
``sigma * clip / batch_size``, and two steps of one seed give the same
noise. The slots' names and initial values (``Adagrad``'s
``initial_accumulator_value``) are JAX's, and so are the
``state_dict`` keys. About 25 s on one core.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.ops.cuda import counters

SHAPES = [(16, 12), (40,), (3, 5, 7)]

# name -> (class name, kwargs, takes weight_decay and grad_clip)
RULES = {
    "adamax": ("Adamax", dict(learning_rate=1e-2), True),
    "adagrad": ("Adagrad", dict(learning_rate=1e-2,
                                initial_accumulator_value=0.1), True),
    "decayed_adagrad": ("DecayedAdagrad", dict(learning_rate=1e-2), True),
    "adadelta": ("Adadelta", dict(learning_rate=1.0), True),
    "rmsprop": ("RMSProp", dict(learning_rate=1e-2), True),
    "rmsprop_centered": ("RMSProp", dict(learning_rate=1e-2, momentum=0.9,
                                         centered=True), True),
    "ftrl": ("Ftrl", dict(learning_rate=1e-1, l1=1e-3, l2=1e-3), True),
    "lars": ("LarsMomentum", dict(learning_rate=0.1), False),
    "dpsgd": ("Dpsgd", dict(learning_rate=0.1, sigma=0.0, seed=3), None),
}
FORMS = ["f32", "bf16_master", "bf16_master_bare", "bf16"]
_JIT = {}


def _make(pkg, name, form, params=None):
    cls, kw, extra = RULES[name]
    kw = dict(kw)
    if extra is not None and form != "bf16_master_bare":
        kw["grad_clip"] = (jnn if pkg is jopt else tnn).ClipGradByGlobalNorm(
            0.05)
    if extra and form != "bf16_master_bare":
        kw["weight_decay"] = 1e-3
    if form.startswith("bf16_master"):
        kw["multi_precision"] = True
    return getattr(pkg, cls)(parameters=params, **kw)


def _jax_update(name, form):
    if (name, form) not in _JIT:
        opt = _make(jopt, name, form)
        _JIT[name, form] = (opt, jax.jit(
            lambda g, p, s: opt.apply_gradients_fn(g, p, s)))
    return _JIT[name, form]


def _unit(x):
    a = x.abs()
    return (a.view(torch.int16) + 1).view(x.dtype).double() - a.double()


def _check(what, got, want, form):
    got, want = got.detach(), torch.from_numpy(np.array(
        want.astype(jnp.float32))).to(got.dtype)
    err = (got.double() - want.double()).abs()
    scale = float(want.double().abs().max())
    if form == "bf16_master" and got.dtype == torch.float32:
        tol = 8e-3 * scale
    elif got.dtype == torch.float32:
        tol = 2e-6 * scale
    else:
        tol = 2 * _unit(want) + 1e-6 * scale
    assert bool((err <= tol).all()), (what, float(err.max()), scale)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", list(RULES))
def test_rule_matches_jax(name, form):
    dt = torch.float32 if form == "f32" else torch.bfloat16
    jdt = jnp.float32 if form == "f32" else jnp.bfloat16
    rng = np.random.RandomState(1)
    ps0 = [rng.randn(*s).astype(np.float32) * 0.05 for s in SHAPES]
    tp = [torch.nn.Parameter(torch.from_numpy(p).to(dt)) for p in ps0]
    to = _make(topt, name, form, tp)
    jo, update = _jax_update(name, form)
    names = [str(i) for i in range(len(SHAPES))]
    jp = {n: jnp.asarray(np.array(p.detach().float()), jdt)
          for n, p in zip(names, tp)}
    js = jo.init_state(jp)
    counters.reset()
    for step in range(2):
        gs = [torch.from_numpy(rng.randn(*s).astype(np.float32)
                               * 0.02).to(dt) for s in SHAPES]
        for p, g in zip(tp, gs):
            p.grad = g
        to.step()
        jp, js = update({n: jnp.asarray(np.array(g.float()), jdt)
                         for n, g in zip(names, gs)}, jp, js)
        for i, n in enumerate(names):
            slots = to._slots[id(tp[i])]
            assert set(slots) == set(js["slots"][n]), (slots.keys(),
                                                       js["slots"][n].keys())
            for k, v in slots.items():
                assert v.dtype == (torch.float32 if "master" in form
                                   else dt)
                _check(f"{name} {form} step {step} {k}{n}", v,
                       js["slots"][n][k], form)
            if "master" not in form:
                _check(f"{name} {form} step {step} p{n}", tp[i], jp[n],
                       form)
            else:
                assert torch.equal(tp[i].detach(), slots["__master__"].to(dt))
    assert counters.get("optimizer_rule." + RULES[name][0]) == 2 * len(SHAPES)
    assert not any(k.startswith("fused_") for k in counters.snapshot())


def test_slots_initial_values_and_state_dict_keys_are_jax_s():
    tp = tnn.Linear(3, 1, bias_attr=False, device="cpu").weight
    to = topt.Adagrad(0.1, parameters=[tp], initial_accumulator_value=0.25)
    tp.grad = torch.zeros(3, 1)
    to.step()
    assert set(to.state_dict()) == {"step", tp.name + "@moment"}
    assert torch.equal(to.state_dict()[tp.name + "@moment"],
                       torch.full((3, 1), 0.25))
    jo = jopt.Adagrad(0.1, initial_accumulator_value=0.25)
    assert float(jo.init_slot(jnp.zeros(3))["moment"][0]) == 0.25
    for cls in ("Adamax", "DecayedAdagrad", "Adadelta", "RMSProp", "Ftrl",
                "LarsMomentum", "Dpsgd"):
        j = getattr(jopt, cls)
        t = getattr(topt, cls)
        lr = {"learning_rate": 0.1}
        assert set(j(**lr).init_slot(jnp.zeros(2))) == set(t.SLOTS), cls


def test_dpsgd_noise_by_its_moments():
    """sigma 1, clip 1, batch 16, lr 1 and zero gradients: p2 - p is
    -(1/16) times the noise of step t, which repeats for the same seed
    and step and differs for the next step."""
    sigma, clip, batch, n = 1.0, 1.0, 16, 1 << 20
    runs = []
    for _ in range(2):
        p = torch.nn.Parameter(torch.zeros(n))
        opt = topt.Dpsgd(1.0, clip=clip, batch_size=batch, sigma=sigma,
                         parameters=[p], seed=5)
        steps = []
        for _ in range(2):
            before = p.detach().clone()
            p.grad = torch.zeros(n)
            opt.step()
            steps.append((before - p.detach()).double() / (sigma * clip
                                                           / batch))
        runs.append(steps)
    noise = runs[0][0]
    assert abs(float(noise.mean())) <= 5 / np.sqrt(n)
    assert abs(float(noise.std()) - 1.0) <= 1e-2
    assert torch.equal(runs[0][0], runs[1][0])
    assert not torch.equal(runs[0][0], runs[0][1])
