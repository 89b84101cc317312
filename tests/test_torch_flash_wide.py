"""Two training paths with attention at head widths 256 and 192 (the
flash kernels' widths beside 64 and 128), at small size, held against
the JAX package on the CPU from the same weights (``load_numpy_state``
of the JAX model's ``state_dict()``) and numpy batches.

- A tiny GPT at head width 256 (vocab 128, hidden 256 in 1 head, 2
  layers, 64 positions, dropout 0), batch 4 x 64, AdamW lr 1e-3 wd
  0.01: two ``TrainStep`` losses within rtol 1e-4 (f32; the sums run in
  another order), attention through the flash route (``attention_plain``
  untouched).
- A tiny BERT at head width 192 (vocab 1024, hidden 384 in 2 heads, 2
  layers, ffn 256, dropout 0), batch 2 x seq 128, ``FLAGS_flash_short_seq``
  on (the port's short-sequence attention; the JAX side keeps its CPU
  attention path, the same function), Lamb lr 1e-3 with
  ``ClipGradByGlobalNorm(1.0)``: two losses within rtol 1e-4, each layer's
  attention through the short form.

The CPU runs the kernels' plain versions (no launch is counted); the
kernels at these widths are held against them on the card
(``chip_smoke.py``'s ``wide`` rows, phases ``gpt_d256`` and
``bert512_d192``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBert
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.nn.clip import ClipGradByGlobalNorm as JClip
from paddle_tpu_torch import get_flags, nn, set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.optimizer import AdamW, Lamb

STEPS, LR = 2, 1e-3


@pytest.fixture
def short_seq_on():
    prev = get_flags("flash_short_seq")
    set_flags({"flash_short_seq": True})
    yield
    set_flags(prev)


@pytest.fixture
def spy(monkeypatch):
    """Calls of the flash wrappers, by name, and the counters reset."""
    calls = []
    for name in ("flash_attention_fwd", "flash_attention_short_fwd"):
        real = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    counters.reset()
    yield calls
    counters.reset()


def _gpt_kw():
    return dict(vocab_size=128, hidden_size=256, num_hidden_layers=2,
                num_attention_heads=1, max_position_embeddings=64,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def test_gpt_at_head_width_256_two_steps_match_jax(spy):
    paddle.seed(0)
    jm = JGPT(JGPTConfig(**_gpt_kw()))
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**_gpt_kw()), device="cpu")
    tgpt.load_numpy_state(tm, {k: v.numpy()
                               for k, v in jm.state_dict().items()})
    jstep = JTrainStep(jm, lambda m, x: m.loss(x),
                       jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                                  weight_decay=0.01))
    tstep = TrainStep(tm, lambda m, x: m.loss(x),
                      AdamW(learning_rate=LR, parameters=tm.parameters(),
                            weight_decay=0.01))
    ids = np.random.RandomState(0).randint(0, 128, (4, 64)).astype(np.int64)
    jl = [float(jstep(paddle.to_tensor(ids)).numpy()) for _ in range(STEPS)]
    tl = [float(tstep(torch.from_numpy(ids))) for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    assert spy == ["flash_attention_fwd"] * (2 * STEPS)   # 2 layers
    assert counters.snapshot() == {}          # the CPU runs plain, uncounted


def _bert_cfg(module):
    cfg = module(vocab_size=1024, hidden_size=384, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=256,
                 max_position_embeddings=128)
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def test_bert_at_head_width_192_short_two_steps_match_jax(short_seq_on,
                                                          spy):
    paddle.seed(0)
    jm = JBert(_bert_cfg(JBertConfig))
    tm = tbert.BertForPretraining(_bert_cfg(tbert.BertConfig), device="cpu")
    tbert.load_numpy_state(tm, {k: v.numpy()
                                for k, v in jm.state_dict().items()})
    jstep = JTrainStep(jm, lambda m, *a: m.loss(*a),
                       jopt.Lamb(learning_rate=LR, lamb_weight_decay=0.01,
                                 parameters=jm.parameters(),
                                 grad_clip=JClip(1.0)))
    tstep = TrainStep(tm, lambda m, *a: m.loss(*a),
                      Lamb(learning_rate=LR, lamb_weight_decay=0.01,
                           parameters=tm.parameters(),
                           grad_clip=nn.ClipGradByGlobalNorm(1.0)))
    rng = np.random.RandomState(0)
    B, L = 2, 128
    ids = rng.randint(0, 1024, (B, L)).astype(np.int32)
    tt = (rng.rand(B, L) < 0.5).astype(np.int32)
    mlm = rng.randint(0, 1024, (B, L)).astype(np.int32)
    mlm[rng.rand(B, L) < 0.85] = -100
    nsp = rng.randint(0, 2, (B,)).astype(np.int32)
    batch = (ids, tt, mlm, nsp)
    jl = [float(jstep(*[paddle.to_tensor(x) for x in batch]).numpy())
          for _ in range(STEPS)]
    tl = [float(tstep(*[torch.from_numpy(x) for x in batch]))
          for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]
    assert spy == ["flash_attention_short_fwd"] * (2 * STEPS)
    assert counters.snapshot() == {}
