"""K1c/K1d over f16 (BERT phase 2 at AMP O1 fp16, the short-sequence
kernels under ``FLAGS_flash_short_seq``): the port's plain versions held
against the JAX package on the CPU, from the same numpy inputs.

- The short forward and backward's plain versions over f16 against
  ``_flash_attention_core_short_fwd`` / ``_bwd`` with ``pl.pallas_call``
  in interpret mode over f16 (b 2, L 128 and 256, h 2, d 64, causal and
  not, dropout 0; dO at 2^15 and at 1 times a unit gradient, N(0, 1) /
  (B L)). Both compute in f32 and write f16 (``flash_attention.py:
  549-562, 570-592``), so they differ by the f32 sums' order: each f16
  output within one f16 unit at its magnitude plus 1e-5 of the largest
  value, lse within 1e-5.
- ``BertConfig.tiny()`` BERT phase 2 as the card's ``bert512_fp16``
  phase drives it, at batch 2 x 128: every dropout at 0, the short flag
  on, ``Lamb`` with ``LinearWarmup(PolynomialDecay)`` and
  ``ClipGradByGlobalNorm(1.0)``, the loss under ``auto_cast(level="O1",
  dtype="float16")``, through ``TrainStep`` (no loss scaler, in either
  package), from JAX's weights carried over by ``load_numpy_state``:
  three losses against JAX's ``TrainStep`` within rtol 5e-3 (the NMT's
  O1 fp16 tolerance, ``tests/test_torch_nmt.py``: f16 GEMMs summed in
  other orders), and the port's attention went through the short form
  over f16, twice a step.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBert
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import amp, get_flags, nn, set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                          load_numpy_state)
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.optimizer import Lamb
from paddle_tpu_torch.optimizer import lr as tlr

FP16_RTOL = 5e-3


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run pallas_call in interpret mode so the JAX kernels run on CPU."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(real, interpret=True))
    counters.reset()
    yield
    counters.reset()


@pytest.fixture
def short_seq_on():
    prev = get_flags("flash_short_seq")
    set_flags({"flash_short_seq": True})
    yield
    set_flags(prev)


def _within_a_unit(got, want, what):
    """Each f16 element within one f16 unit at its magnitude plus 1e-5 of
    the largest value."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    big = np.maximum(np.abs(got), np.abs(want)).astype(np.float16)
    unit = (np.nextafter(big, np.float16(np.inf)) - big).astype(np.float32)
    ratio = (np.abs(got - want)
             / (unit + 1e-5 * float(np.abs(want).max()))).max()
    assert ratio <= 1.0, (what, ratio)


def _f16_inputs(l, seed, scale, b=2, h=2, d=64):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, l, h, d).astype(np.float16) for _ in range(3))
    do = (rng.randn(b, l, h, d) * scale / (b * l)).astype(np.float16)
    return q, k, v, do


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("l", [128, 256])
def test_f16_short_forward_matches_the_pallas_short_kernel(interpret_pallas,
                                                           causal, l):
    q, k, v, _ = _f16_inputs(l, l, 1.0)
    jout, res = jfa._flash_attention_core_short_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, causal, 0.0)
    assert jout.dtype == jnp.float16
    out, lse = tfa.flash_attention_short_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), causal)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    _within_a_unit(out.numpy(), np.asarray(jout), "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[4])[:, 0, :],
                               atol=1e-5, rtol=0)
    assert counters.snapshot() == {}                  # the CPU runs plain


@pytest.mark.parametrize("scale", [2.0 ** 15, 1.0], ids=["scale2^15",
                                                         "scale1"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("l", [128, 256])
def test_f16_short_backward_matches_the_pallas_short_kernel(
        interpret_pallas, causal, l, scale):
    """dq, dk, dv of JAX's ``_short_bwd_kernel`` (through
    ``_flash_attention_core_short_bwd``) and of the port's plain short
    backward, both from JAX's out and lse."""
    q, k, v, do = _f16_inputs(l, l + 1, scale)
    jout, res = jfa._flash_attention_core_short_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, causal, 0.0)
    jgrads = jfa._flash_attention_core_short_bwd(causal, 0.0, res,
                                                 jnp.asarray(do))[:3]
    lse = torch.from_numpy(np.asarray(res[4])[:, 0, :].copy())
    grads = tfa.flash_attention_short_bwd(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(np.array(jout)), lse, torch.from_numpy(do), causal)
    for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        assert got.dtype == torch.float16 and want.dtype == jnp.float16
        _within_a_unit(got.numpy(), np.asarray(want), name)
    assert counters.snapshot() == {}


def _schedule(m):
    return m.LinearWarmup(m.PolynomialDecay(1e-3, decay_steps=1000,
                                            end_lr=0.0),
                          warmup_steps=3, start_lr=0.0, end_lr=1e-3)


def _no_dropout(cfg):
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def test_bert_phase2_o1_fp16_three_lamb_steps_match_jax(short_seq_on,
                                                        monkeypatch):
    paddle.seed(0)
    jm = JBert(_no_dropout(JBertConfig.tiny()))
    tm = BertForPretraining(_no_dropout(BertConfig.tiny()), device="cpu")
    load_numpy_state(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    jsched, tsched = _schedule(jlr), _schedule(tlr)

    def jloss(m, *a):
        with jamp.auto_cast(level="O1", dtype="float16"):
            return m.loss(*a)

    def tloss(m, *a):
        with amp.auto_cast(level="O1", dtype="float16"):
            return m.loss(*a)

    jstep = JTrainStep(jm, jloss,
                       jopt.Lamb(learning_rate=jsched, lamb_weight_decay=0.01,
                                 parameters=jm.parameters(),
                                 grad_clip=JClip(1.0)))
    tstep = TrainStep(tm, tloss,
                      Lamb(learning_rate=tsched, lamb_weight_decay=0.01,
                           parameters=tm.parameters(),
                           grad_clip=nn.ClipGradByGlobalNorm(1.0)))
    seen = []
    real = tfa.flash_attention_short_fwd
    monkeypatch.setattr(tfa, "flash_attention_short_fwd",
                        lambda q, *a: seen.append(q.dtype) or real(q, *a))
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
    for _ in range(3):
        jl.append(float(jstep(*[paddle.to_tensor(x) for x in batch])
                        .numpy()))
        tl.append(float(tstep(*[torch.from_numpy(x) for x in batch])))
        jsched.step()
        tsched.step()
    np.testing.assert_allclose(tl, jl, rtol=FP16_RTOL)
    assert seen == [torch.float16] * (3 * 2)          # 2 layers, 3 steps
    assert counters.snapshot() == {}                  # the CPU runs plain
