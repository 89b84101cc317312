"""K3's 2-byte forms without masters (bf16/f16 parameters whose state is
of their own type: ``multi_precision=False``, ``amp.decorate(level="O2",
master_weight=False)``) held against the JAX package on the CPU.

JAX runs these updates in XLA (its fused gate sends every non-f32 update
there, ``paddle_tpu/ops/pallas/fused_optimizer.py:305-306``): the
optimizer's ``rule`` in the parameter's type. The port's plain versions
(what the card's kernels are held to bit for bit) compute each operation
in f32 and round it to the type.

- SGD (with and without its coupled L2 term), Momentum (with and
  without Nesterov), Adam, AdamW and Lamb, two steps through the port's
  optimizers against ``apply_gradients_fn`` from the same numpy inputs,
  parameters and every slot compared after each step, each step from
  the port's parameters and state (JAX's set to them before it). bf16:
  bit for bit
  (XLA on the CPU rounds bf16 after every operation too). f16: XLA keeps
  a fused multiply-add chain in f32 and rounds once (``0.9*v + g``), so
  each element is held by the 2-byte rule: one unit of f16 at the
  element plus four unit roundoffs of the 2-norm of the terms of its
  last sum (for p: p and the update; for a moment: its two addends).
- Tiny BERT at ``decorate(level="O2", master_weight=False)`` (bf16
  weights and AdamW moments, no master): three ``TrainStep`` losses
  against JAX's, rtol 2e-2 as for O2 with masters
  (``test_torch_bert_o2.py``: JAX's XLA head rounds the logits to bf16,
  the port's keeps f32), every parameter and moment bf16 and no master.

About 20 s on one core (JAX compiles shared through one jitted update a
rule and type).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBert
from paddle_tpu.utils import unique_name as jun
from paddle_tpu_torch import amp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                          load_numpy_state)
from paddle_tpu_torch.utils import unique_name as tun
from test_torch_bert import _batch, _no_dropout

SHAPES = [(64, 33), (257,), (8, 8, 3)]
UNIT_ROUNDOFF = {"float16": 2.0 ** -11}

# rule -> (JAX optimizer, port optimizer, slots, (p, g, state) scales)
RULES = {
    "sgd": (lambda: jopt.SGD(learning_rate=0.1),
            lambda ps: topt.SGD(0.1, parameters=ps), ()),
    "sgd_l2": (lambda: jopt.SGD(learning_rate=0.1, weight_decay=1e-2),
               lambda ps: topt.SGD(0.1, parameters=ps, weight_decay=1e-2),
               ()),
    "momentum": (lambda: jopt.Momentum(learning_rate=0.1, momentum=0.9),
                 lambda ps: topt.Momentum(0.1, 0.9, parameters=ps),
                 ("velocity",)),
    "nesterov": (lambda: jopt.Momentum(learning_rate=0.1, momentum=0.9,
                                       use_nesterov=True),
                 lambda ps: topt.Momentum(0.1, 0.9, parameters=ps,
                                          use_nesterov=True),
                 ("velocity",)),
    "adam": (lambda: jopt.Adam(learning_rate=1e-3),
             lambda ps: topt.Adam(1e-3, parameters=ps),
             ("moment1", "moment2")),
    "adamw": (lambda: jopt.AdamW(learning_rate=1e-3, weight_decay=0.01),
              lambda ps: topt.AdamW(1e-3, parameters=ps, weight_decay=0.01),
              ("moment1", "moment2")),
    "lamb": (lambda: jopt.Lamb(learning_rate=1e-3, lamb_weight_decay=0.01),
             lambda ps: topt.Lamb(1e-3, 0.01, parameters=ps),
             ("moment1", "moment2")),
}
_JIT = {}


def _unit(x):
    """One unit of x's 2-byte type at |x| (the gap to the next value up),
    in f64."""
    a = x.abs()
    up = (a.view(torch.int16) + 1).view(x.dtype)
    return (up.double() - a.double())


def _terms(rule, p, g, state, lr, t):
    """The 2-norm (f64) of the terms each output sums, expanded through
    the rule's chain: for p, p and the parts of its update (a moment's
    two addends carried through); for each moment its two addends."""
    p, g = p.double(), g.double()
    out = {}
    if rule.startswith("sgd"):
        out["p"] = (p, lr * g) + ((lr * 1e-2 * p,) if rule == "sgd_l2"
                                  else ())
    elif rule in ("momentum", "nesterov"):
        v = state["velocity"].double()
        out["velocity"] = (0.9 * v, g)
        out["p"] = (p, lr * 0.9 * v, lr * g) if rule == "momentum" \
            else (p, lr * g, lr * 0.81 * v, lr * 0.9 * g)
    else:
        m, v = state["moment1"].double(), state["moment2"].double()
        out["moment1"] = (0.9 * m, 0.1 * g)
        out["moment2"] = (0.999 * v, 0.001 * g * g)
        c1, c2 = 1 - 0.9 ** t, 1 - 0.999 ** t
        eps = 1e-6 if rule == "lamb" else 1e-8
        den = ((0.999 * v + 0.001 * g * g) / c2).sqrt() + eps
        parts = (0.9 * m / c1 / den, 0.1 * g / c1 / den)
        if rule == "lamb":
            r = parts[0] + parts[1] + 0.01 * p
            trust = p.norm() / r.norm() if p.norm() > 0 else 1.0
            out["p"] = (p,) + tuple(lr * trust * x for x in parts) + (
                lr * trust * 0.01 * p,)
        else:
            out["p"] = (p,) + tuple(lr * x for x in parts) + (
                (0.01 * lr * p,) if rule == "adamw" else ())
    return {k: torch.stack(v).norm(dim=0) for k, v in out.items()}


def _close(name, got, want, terms, dtype_name):
    """bf16: bit for bit; f16: the 2-byte rule."""
    if dtype_name == "bfloat16":
        assert torch.equal(got, want), (name, float(
            (got.double() - want.double()).abs().max()))
        return
    # f16 Adam's v leaves the normal range where |g| < 0.25 and eps 1e-8
    # is 0 in f16: where v rounds to 0 the update is infinite (and the
    # next step NaN) in both packages; those elements must agree exactly
    inf = ~torch.isfinite(want)
    a, b = got[inf], want[inf]
    assert torch.equal(inf, ~torch.isfinite(got)) and bool(
        ((a == b) | (a.isnan() & b.isnan())).all()), (name, int(inf.sum()))
    err = (got.double() - want.double()).abs()[~inf]
    tol = (_unit(want) + 4 * UNIT_ROUNDOFF[dtype_name] * terms)[~inf]
    assert bool((err <= tol).all()), (name, float((err / tol).max()))


def _jax_update(rule, dtype_name):
    key = (rule, dtype_name)
    if key not in _JIT:
        opt = RULES[rule][0]()
        _JIT[key] = jax.jit(lambda g, p, s: opt.apply_gradients_fn(g, p, s))
    return _JIT[key]


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float16"])
@pytest.mark.parametrize("rule", list(RULES))
def test_no_master_rules_match_jax(rule, dtype_name):
    dt = getattr(torch, dtype_name)
    jdt = getattr(jnp, dtype_name)
    rng = np.random.RandomState(0)
    # f16: Adam's and Lamb's first v = 0.001 g^2 is an f16 subnormal at
    # |g| ~ 1e-2, where a rounding decides whether it is 0 (and with eps
    # 1e-8 rounding to 0, the update infinite): the moment rules take
    # gradients of unit scale in f16
    g_s = 1e-3 if dtype_name == "bfloat16" else \
        1.0 if "moment1" in RULES[rule][2] else 1e-2
    ps0 = [rng.randn(*s).astype(np.float32) * 0.05 for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) * g_s for s in SHAPES]
             for _ in range(2)]
    tp = [torch.nn.Parameter(torch.from_numpy(p).to(dt)) for p in ps0]
    topt_ = RULES[rule][1](tp)
    slots = RULES[rule][2]
    names = [str(i) for i in range(len(SHAPES))]
    jp = {n: jnp.asarray(np.asarray(p.detach().float()), jdt)
          for n, p in zip(names, tp)}
    js = {"slots": {n: {k: jnp.zeros_like(jp[n]) for k in slots}
                    for n in names}, "step": jnp.asarray(0, jnp.int32)}
    update = _jax_update(rule, dtype_name)
    lr = topt_.get_lr()
    for step, gs in enumerate(grads, 1):
        tg = [torch.from_numpy(g).to(dt) for g in gs]
        before = {n: ([p.detach().clone() for p in tp][i],
                      {k: topt_._slot(tp[i])[k].clone() for k in slots})
                  for i, n in enumerate(names)}
        for p, g in zip(tp, tg):
            p.grad = g
        topt_.step()
        jg = {n: jnp.asarray(np.asarray(g.float()), jdt)
              for n, g in zip(names, tg)}
        # each step from the port's inputs: a unit carried in the state
        # from the step before would otherwise grow through the next one
        jp = {n: jnp.asarray(np.asarray(before[n][0].float()), jdt)
              for n in names}
        js = {"slots": {n: {k: jnp.asarray(np.asarray(v.float()), jdt)
                            for k, v in before[n][1].items()}
                        for n in names}, "step": js["step"]}
        jp, js = update(jg, jp, js)
        for i, n in enumerate(names):
            terms = _terms(rule, before[n][0], tg[i], before[n][1], lr,
                           step)
            _close(f"{rule} step {step} p{n}", tp[i].detach(),
                   torch.from_numpy(np.array(jp[n].astype(jnp.float32)))
                   .to(dt), terms["p"], dtype_name)
            for k in slots:
                got = topt_._slot(tp[i])[k]
                assert got.dtype == dt and "__master__" not in \
                    topt_._slot(tp[i])
                want = torch.from_numpy(np.array(
                    js["slots"][n][k].astype(jnp.float32))).to(dt)
                _close(f"{rule} step {step} {k}{n}", got, want,
                       terms.get(k, terms["p"]), dtype_name)


def _decorated_pure():
    paddle.seed(0)
    with jun.guard():
        jm = JBert(_no_dropout(JBertConfig.tiny()))
    with tun.guard():
        tm = BertForPretraining(_no_dropout(BertConfig.tiny()), device="cpu")
    load_numpy_state(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                    weight_decay=0.01)
    to = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                    weight_decay=0.01)
    jamp.decorate(jm, jo, level="O2", dtype="bfloat16", master_weight=False)
    amp.decorate(tm, to, level="O2", dtype="bfloat16", master_weight=False)
    return jm, tm, jo, to


def _jloss(m, *a):
    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        return m.loss(*a)


def _tloss(m, *a):
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        return m.loss(*a)


def test_tiny_bert_o2_without_masters_matches_jax():
    jm, tm, jo, to = _decorated_pure()
    jstep, tstep = JTrainStep(jm, _jloss, jo), TrainStep(tm, _tloss, to)
    batch = _batch()
    jargs = [paddle.to_tensor(x) for x in batch]
    targs = [torch.from_numpy(x) for x in batch]
    jl, tl = [], []
    for _ in range(3):
        jl.append(float(jstep(*jargs).numpy()))
        tl.append(float(tstep(*targs)))
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert to._step_count == 3
    for p in tm.parameters():
        assert p.dtype == torch.bfloat16
        slots = to._slots[id(p)]
        assert "__master__" not in slots
        assert all(v.dtype == torch.bfloat16 for v in slots.values())
