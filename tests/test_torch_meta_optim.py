"""The meta-optimizers (``paddle_tpu_torch/optimizer/meta.py``) held
against the JAX package's (``paddle_tpu/optimizer/meta.py``) on the CPU.

- ``GradientMergeOptimizer(k_steps=4)`` over Momentum, ``LookAhead(k=2)``
  over SGD, ``EMA`` and ``ModelAverage`` over SGD steps, and
  ``DGCMomentum`` with a warm-up schedule (momentum at step 1, sparsity
  0.75 at step 2, 0.999 at step 3), driven eagerly with the same numpy
  gradients set on both packages' parameters: parameters, slots and the
  averages within rtol 1e-6 of each tensor's largest value (f32,
  measured: bit for bit but for XLA's fused chains), GradientMerge's
  step verdicts equal, DGC's residuals zero at the same places (its
  masks bit for bit: the k-th largest |v| of ``torch.topk`` and of
  ``lax.top_k`` are the same value).
- ``recompute`` with dropout: a tiny BERT's step under
  ``RecomputeOptimizer`` with every encoder layer a checkpoint gives
  gradients bit for bit those of the same step without it, at O0 and
  at O1 bf16, with attention and hidden dropout 0.1 (the replay rewinds
  the step's generators: the flash kernels' plain versions get the same
  seeds, the dropout masks are the same bits), and the step's generator
  ends where the run without recompute leaves it. Against JAX, loss
  parity only (dropout 0, rtol 1e-4 as ``test_torch_bert.py``'s O0
  steps): the reference's remat is no clean oracle.
- ``LocalSGDOptimizer`` and ``PipelineOptimizer`` raise, naming slice
  11; ``RecomputeOptimizer.minimize`` on a static variable raises,
  naming slice 9; a Tensor keyword argument of ``recompute`` raises
  ``ValueError``, as in JAX.

About 20 s on one core.
"""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.tensor import Tensor as JTensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBert
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework.random import StepRNG, rng_scope
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                          load_numpy_state)
from test_torch_bert import _batch, _no_dropout


def _pair():
    """A JAX and a port ``Linear(12, 6)`` with the same weights."""
    paddle.seed(0)
    jl = jnn.Linear(12, 6)
    tl = tnn.Linear(12, 6, device="cpu")
    load_numpy_state(tl, {k: v.numpy() for k, v in jl.state_dict().items()})
    return jl, tl


def _grads(n, seed=0):
    rng = np.random.RandomState(seed)
    return [[rng.randn(12, 6).astype(np.float32) * 0.1,
             rng.randn(6).astype(np.float32) * 0.1] for _ in range(n)]


def _set(jl, tl, gs):
    for jp, tp, g in zip(jl.parameters(), tl.parameters(), gs):
        jp.grad = JTensor(jnp.asarray(g))
        tp.grad = torch.from_numpy(g.copy())


def _close(a, b, what):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b.value if hasattr(b, "value") else b)
    scale = float(np.abs(b).max()) or 1.0
    assert float(np.abs(a - b).max()) <= 1e-6 * scale, what


def _params_close(jl, tl, what):
    for jp, tp in zip(jl.parameters(), tl.parameters()):
        _close(tp, jp.value, what)


def test_gradient_merge_matches_jax():
    jl, tl = _pair()
    jo = jopt.GradientMergeOptimizer(
        jopt.Momentum(0.1, 0.9, parameters=jl.parameters()), k_steps=4)
    to = topt.GradientMergeOptimizer(
        topt.Momentum(0.1, 0.9, parameters=tl.parameters()), k_steps=4)
    for i, gs in enumerate(_grads(8)):
        _set(jl, tl, gs)
        assert jo.step() == to.step() == (i % 4 == 3)
        assert all(p.grad is None for p in tl.parameters())
        _params_close(jl, tl, f"call {i}")


def test_lookahead_matches_jax():
    jl, tl = _pair()
    jo = jopt.LookAhead(jopt.SGD(0.1, parameters=jl.parameters()),
                        alpha=0.5, k=2)
    to = topt.LookAhead(topt.SGD(0.1, parameters=tl.parameters()),
                        alpha=0.5, k=2)
    for i, gs in enumerate(_grads(5)):
        _set(jl, tl, gs)
        jo.step()
        to.step()
        _params_close(jl, tl, f"step {i}")


@pytest.mark.parametrize("kind", ["EMA", "ModelAverage"])
def test_averages_match_jax(kind):
    jl, tl = _pair()
    ja = jopt.EMA(0.9) if kind == "EMA" else jopt.ModelAverage()
    ta = topt.EMA(0.9) if kind == "EMA" else topt.ModelAverage()
    ja.register(jl.parameters())
    ta.register(tl.parameters())
    jo = jopt.SGD(0.1, parameters=jl.parameters())
    to = topt.SGD(0.1, parameters=tl.parameters())
    for gs in _grads(3):
        _set(jl, tl, gs)
        jo.step()
        to.step()
        ja.update()
        ta.update()
    fast = [p.detach().clone() for p in tl.parameters()]
    ja.apply()
    ta.apply()
    _params_close(jl, tl, "applied")
    ja.restore()
    ta.restore()
    assert all(torch.equal(p, f) for p, f in zip(tl.parameters(), fast))
    _params_close(jl, tl, "restored")


def test_dgc_momentum_with_warmup_matches_jax():
    jl, tl = _pair()
    kw = dict(momentum=0.9, rampup_begin_step=1, rampup_step=2,
              sparsity=[0.75, 0.999])
    jo = jopt.DGCMomentum(0.1, parameters=jl.parameters(), **kw)
    to = topt.DGCMomentum(0.1, parameters=tl.parameters(), **kw)
    assert [to.sparsity_at(t) for t in (1, 2, 3, 4)] == [None, 0.75, 0.999,
                                                        0.999]
    masks = []
    inner = to.mask
    to.mask = lambda v, s: masks.append(inner(v, s)) or masks[-1]
    for i, gs in enumerate(_grads(3, seed=1)):
        _set(jl, tl, gs)
        jo.step()
        to.step()
        _params_close(jl, tl, f"step {i}")
        for jp, tp in zip(jl.parameters(), tl.parameters()):
            js, ts = jo._slots[id(jp)], to._slots[id(tp)]
            for k in ("velocity", "u", "v"):
                _close(ts[k], js[k], f"step {i} {k}")
            assert np.array_equal(ts["v"].numpy() == 0,
                                  np.asarray(js["v"]) == 0), f"step {i}"
    # step 2 keeps a quarter of each tensor (int(72 * 0.25), int(6 * 0.25)
    # elements), step 3 one element of each
    assert [int(m.sum()) for m in masks] == [18, 1, 1, 1]


def _bert_step(recompute, level, dropout):
    """One forward and backward of a tiny BERT in a fixed StepRNG scope,
    with every encoder layer a recompute checkpoint or not: (gradients,
    the generators' states after the step)."""
    torch.manual_seed(0)
    cfg = BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = dropout
    model = BertForPretraining(cfg, device="cpu", generator=torch.Generator()
                               .manual_seed(3))
    opt = topt.AdamW(1e-3, parameters=model.parameters())
    if recompute:
        opt = topt.RecomputeOptimizer(opt)
        opt._set_checkpoints(list(model.bert.encoder.layers))
    args = [torch.from_numpy(x) for x in _batch()]
    rng = StepRNG(1234, "cpu")
    with rng_scope(rng):
        with amp.auto_cast(level=level, dtype="bfloat16"):
            loss = model.loss(*args)
        loss.backward()
    return ([p.grad for p in model.parameters()],
            (rng.generator.get_state(), rng._host.get_state()))


@pytest.mark.parametrize("level", ["O0", "O1"])
def test_recompute_with_dropout_gives_the_same_gradients(level):
    want, want_rng = _bert_step(False, level, 0.1)
    got, got_rng = _bert_step(True, level, 0.1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got_rng, want_rng))


def test_recompute_loss_parity_with_jax():
    paddle.seed(0)
    jm = JBert(_no_dropout(JBertConfig.tiny()))
    tm = BertForPretraining(_no_dropout(BertConfig.tiny()), device="cpu")
    load_numpy_state(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    jo = jopt.RecomputeOptimizer(jopt.AdamW(1e-3,
                                            parameters=jm.parameters()))
    to = topt.RecomputeOptimizer(topt.AdamW(1e-3,
                                            parameters=tm.parameters()))
    jo._set_checkpoints(list(jm.bert.encoder.layers))
    to._set_checkpoints(list(tm.bert.encoder.layers))
    batch = _batch()
    jstep = JTrainStep(jm, lambda m, *a: m.loss(*a), jo.inner)
    tstep = TrainStep(tm, lambda m, *a: m.loss(*a), to)
    jl = [float(jstep(*[paddle.to_tensor(x) for x in batch]).numpy())
          for _ in range(2)]
    tl = [float(tstep(*[torch.from_numpy(x) for x in batch]))
          for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)


def test_what_later_slices_bring_raises():
    tl = tnn.Linear(2, 2, device="cpu")
    sgd = topt.SGD(0.1, parameters=tl.parameters())
    with pytest.raises(NotImplementedError, match="slice 11"):
        topt.LocalSGDOptimizer(sgd, k_steps=2)
    with pytest.raises(NotImplementedError, match="slice 11"):
        topt.PipelineOptimizer(sgd, num_microbatches=2)
    with pytest.raises(NotImplementedError, match="slice 9"):
        topt.RecomputeOptimizer(sgd).minimize(object())
    with pytest.raises(ValueError, match="keyword"):
        x = torch.ones(2, requires_grad=True)
        topt.recompute(lambda a, b=None: a, x, b=copy.copy(x))
