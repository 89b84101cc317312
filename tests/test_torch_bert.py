"""The port's BERT pretraining step (paddle_tpu_torch: models.bert, nn,
amp, optimizer, jit.TrainStep) held against the JAX package on the CPU.

Tiny BERT (``BertConfig.tiny()``: 2 layers, hidden 128, vocab 1024),
batch 2 x seq 128, every dropout at 0, AdamW lr 1e-3 and weight decay
0.01. The JAX model is built from ``paddle_tpu.seed(0)`` and its
``state_dict()`` is carried into the port by name
(``load_numpy_state``); the batch is numpy. On the CPU the port's
kernels run their plain versions and the JAX side its XLA paths.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBert
from paddle_tpu_torch import amp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                          load_numpy_state)
from paddle_tpu_torch.optimizer import AdamW

B, L = 2, 128


def _no_dropout(cfg):
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _models():
    paddle.seed(0)
    jm = JBert(_no_dropout(JBertConfig.tiny()))
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    tm = BertForPretraining(_no_dropout(BertConfig.tiny()), device="cpu")
    load_numpy_state(tm, state)
    return jm, tm


def _batch(seed=0, vocab=1024):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (B, L)).astype(np.int32)
    tt = (rng.rand(B, L) < 0.5).astype(np.int32)
    mlm = rng.randint(0, vocab, (B, L)).astype(np.int32)
    mlm[rng.rand(B, L) < 0.85] = -100           # MLM: ~15% of positions
    nsp = rng.randint(0, 2, (B,)).astype(np.int32)
    return ids, tt, mlm, nsp


def _steps(level, n):
    jm, tm = _models()

    def jloss(m, *a):
        with jamp.auto_cast(level=level, dtype="bfloat16"):
            return m.loss(*a)

    def tloss(m, *a):
        with amp.auto_cast(level=level, dtype="bfloat16"):
            return m.loss(*a)

    jstep = JTrainStep(jm, jloss, jopt.AdamW(learning_rate=1e-3,
                                             parameters=jm.parameters(),
                                             weight_decay=0.01))
    tstep = TrainStep(tm, tloss, AdamW(learning_rate=1e-3,
                                       parameters=tm.parameters(),
                                       weight_decay=0.01))
    batch = _batch()
    jargs = [paddle.to_tensor(x) for x in batch]
    targs = [torch.from_numpy(x) for x in batch]
    jl, tl = [], []
    for _ in range(n):
        jl.append(float(jstep(*jargs).numpy()))
        tl.append(float(tstep(*targs)))
    return np.array(jl), np.array(tl), jm, tm


def test_state_dict_keys_and_shapes_match_the_jax_model():
    jm, tm = _models()
    js = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    ts = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert js == ts
    assert len(ts) == 46


def test_o0_five_steps_match_jax():
    """f32 throughout: the two sides differ only in summation order, so
    the losses agree to rtol 1e-4 over five AdamW steps. (The weights
    are not compared elementwise: the key projection's bias has an
    exactly-zero true gradient, and Adam's m/sqrt(v) turns the
    last-bit noise there into lr-sized steps of either sign.)"""
    jl, tl, _, _ = _steps("O0", 5)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_o0_step_one_gradients_match_jax():
    """Every gradient of the loss at the carried-over weights, within
    atol 1e-5 + rtol 1e-4 (f32; summation order only)."""
    jm, tm = _models()
    batch = _batch()
    jm.train()
    jl = jm.loss(*[paddle.to_tensor(x) for x in batch])
    jl.backward()
    tl = tm.loss(*[torch.from_numpy(x) for x in batch])
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), rtol=1e-5)
    jgrads = {n: p.grad.numpy() for n, p in jm.named_parameters()}
    tgrads = dict(tm.named_parameters())
    assert set(jgrads) == set(tgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name].grad.numpy(), g, atol=1e-5,
                                   rtol=1e-4, err_msg=name)


def test_o1_bf16_two_steps_match_jax():
    """AMP O1 (bf16 linear layers, f32 norms and losses): bf16 keeps
    ~3 significant digits and the two frameworks round at different
    places (XLA fuses the bias add, PyTorch rounds the product first;
    attention's probabilities stay f32 in the port's kernel path and
    go bf16 in JAX's XLA path), so the losses agree to rtol 2e-2."""
    jl, tl, _, _ = _steps("O1", 2)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)


def test_entry_points_need_a_device_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("the card is present: device=None builds on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BertForPretraining(BertConfig.tiny())


def test_o1_casts_follow_the_jax_lists():
    """Under O1 the port casts what the JAX package's lists say: linear
    down to bf16, layer_norm and the NSP loss up to f32, attention and
    the fused MLM loss left as given (so attention sees bf16 q/k/v from
    the bf16 projections and the MLM head f32 h and W)."""
    f32 = torch.zeros(2, dtype=torch.float32)
    bf = torch.zeros(2, dtype=torch.bfloat16)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        assert {t.dtype for t in amp.maybe_cast_inputs("linear", [f32, bf])} \
            == {torch.bfloat16}
        for op in ("layer_norm", "softmax_with_cross_entropy"):
            assert {t.dtype for t in amp.maybe_cast_inputs(op, [f32, bf])} \
                == {torch.float32}
        for op in ("sdpa", "fused_linear_cross_entropy", "gelu"):
            assert [t.dtype for t in amp.maybe_cast_inputs(op, [f32, bf])] \
                == [torch.float32, torch.bfloat16]
    assert amp.maybe_cast_inputs("linear", [f32])[0].dtype == torch.float32


def test_dropout_steps_replay_by_seed():
    """With dropout on, a step is a function of (weights, batch, seed,
    step): two runs from one seed give the same losses, another seed
    other losses."""
    batch = [torch.from_numpy(x) for x in _batch(seed=1)]

    def run(seed):
        from paddle_tpu_torch.framework.random import seed as pt_seed

        pt_seed(7)
        cfg = BertConfig.tiny()
        cfg.num_hidden_layers = 1
        m = BertForPretraining(cfg, device="cpu")
        step = TrainStep(m, lambda mm, *a: mm.loss(*a),
                         AdamW(learning_rate=1e-3,
                               parameters=m.parameters()), seed=seed)
        return [step(*batch).item() for _ in range(2)]

    a, b, c = run(0), run(0), run(1)
    assert a == b
    assert a != c


def test_load_numpy_state_refuses_missing_extra_and_misshapen_keys():
    cfg = BertConfig.tiny()
    cfg.num_hidden_layers = 1
    m = BertForPretraining(cfg, device="cpu")
    state = {k: v.numpy().copy() for k, v in m.state_dict().items()}
    load_numpy_state(m, state)
    missing = dict(state)
    missing.pop("mlm_bias")
    with pytest.raises(KeyError, match="mlm_bias"):
        load_numpy_state(m, missing)
    with pytest.raises(KeyError, match="extra"):
        load_numpy_state(m, {**state, "bert.extra.weight": state["mlm_bias"]})
    bad = dict(state)
    bad["nsp.weight"] = bad["nsp.weight"].T
    with pytest.raises(ValueError, match="nsp.weight"):
        load_numpy_state(m, bad)
