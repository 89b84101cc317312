"""The slice's two training paths held against the JAX package on the
CPU, from the same weights (``load_numpy_state``) and numpy batches:

- BERT phase-2 pretraining as the chip run drives it, at the tiny
  configuration: ``BertConfig.tiny()`` (2 layers, hidden 128, vocab
  1024), batch 2 x seq 128, every dropout at 0, ``FLAGS_flash_short_seq``
  on (the port's short-sequence attention; the JAX side keeps its CPU
  attention path, the same function), ``Lamb`` with
  ``LinearWarmup(PolynomialDecay)`` stepped after each step and
  ``ClipGradByGlobalNorm(1.0)``: five O0 losses within rtol 1e-4.
- LeNet as ``bench_mnist`` shapes it, trained by ``SGD`` lr 0.01 with
  coupled L2 1e-4: three losses within rtol 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBert
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.vision import models as jvm
from paddle_tpu_torch import get_flags, nn, set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                          load_numpy_state)
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.optimizer import SGD, Lamb
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.vision import models as tvm


@pytest.fixture
def short_seq_on():
    prev = get_flags("flash_short_seq")
    set_flags({"flash_short_seq": True})
    yield
    set_flags(prev)


def _schedule(m):
    return m.LinearWarmup(m.PolynomialDecay(1e-3, decay_steps=1000,
                                            end_lr=0.0),
                          warmup_steps=3, start_lr=0.0, end_lr=1e-3)


def _no_dropout(cfg):
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def test_bert_lamb_five_o0_steps_match_jax(short_seq_on, monkeypatch):
    """Five Lamb steps through the warm-up into the decay: the losses
    within rtol 1e-4 (f32; the sums run in another order), and the
    port's attention went through the short form."""
    paddle.seed(0)
    jm = JBert(_no_dropout(JBertConfig.tiny()))
    tm = BertForPretraining(_no_dropout(BertConfig.tiny()), device="cpu")
    load_numpy_state(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    jsched, tsched = _schedule(jlr), _schedule(tlr)
    jstep = JTrainStep(jm, lambda m, *a: m.loss(*a),
                       jopt.Lamb(learning_rate=jsched, lamb_weight_decay=0.01,
                                 parameters=jm.parameters(),
                                 grad_clip=JClip(1.0)))
    tstep = TrainStep(tm, lambda m, *a: m.loss(*a),
                      Lamb(learning_rate=tsched, lamb_weight_decay=0.01,
                           parameters=tm.parameters(),
                           grad_clip=nn.ClipGradByGlobalNorm(1.0)))
    from paddle_tpu_torch.ops.cuda import flash_attention as tfa

    short_calls = []
    real = tfa.flash_attention_short_fwd
    monkeypatch.setattr(tfa, "flash_attention_short_fwd",
                        lambda *a: short_calls.append(1) or real(*a))
    rng = np.random.RandomState(0)
    B, L = 2, 128
    ids = rng.randint(0, 1024, (B, L)).astype(np.int32)
    tt = (rng.rand(B, L) < 0.5).astype(np.int32)
    mlm = rng.randint(0, 1024, (B, L)).astype(np.int32)
    mlm[rng.rand(B, L) < 0.85] = -100
    nsp = rng.randint(0, 2, (B,)).astype(np.int32)
    batch = (ids, tt, mlm, nsp)
    jl, tl = [], []
    counters.reset()        # an earlier test on this worker may leave counts
    for _ in range(5):
        jl.append(float(jstep(*[paddle.to_tensor(x) for x in batch])
                        .numpy()))
        tl.append(float(tstep(*[torch.from_numpy(x) for x in batch])))
        jsched.step()
        tsched.step()
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    assert len(short_calls) == 5 * 2              # 2 layers, 5 steps
    assert counters.snapshot() == {}              # the CPU runs plain


def test_lenet_three_sgd_steps_match_jax():
    """LeNet, batch 8 x 1 x 28 x 28, SGD lr 0.01 with coupled L2 1e-4:
    three losses within rtol 1e-4."""
    paddle.seed(0)
    jm = jvm.LeNet(num_classes=10)
    tm = tvm.LeNet(num_classes=10, device="cpu")
    tvm.load_numpy_state(tm, {k: v.numpy()
                              for k, v in jm.state_dict().items()})
    jce, tce = jnn.CrossEntropyLoss(), nn.CrossEntropyLoss()
    jstep = JTrainStep(jm, lambda m, x, y: jce(m(x), y),
                       jopt.SGD(learning_rate=0.01, weight_decay=1e-4,
                                parameters=jm.parameters()))
    tstep = TrainStep(tm, lambda m, x, y: tce(m(x), y),
                      SGD(learning_rate=0.01, weight_decay=1e-4,
                          parameters=tm.parameters()))
    rng = np.random.RandomState(1)
    x = rng.randn(8, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, (8,)).astype(np.int64)
    jl = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
          for _ in range(3)]
    tl = [float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
