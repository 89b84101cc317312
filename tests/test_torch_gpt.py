"""The port's GPT (paddle_tpu_torch/models/gpt.py) and its
sequence-parallel training step held against the JAX package on the CPU.

``GPTConfig.tiny()`` (vocab 128, hidden 32, 2 layers, 4 heads, 64
positions, dropout 0), batch 4 x 64, AdamW lr 1e-3 and weight decay
0.01. The JAX model is built from ``paddle_tpu.seed(0)`` and its
``state_dict()`` carried into the port by name; the ids are numpy.

- forward logits and the loss against the JAX model; causal
  ``MultiHeadAttention`` with a key-padding mask against the JAX layer;
- three single-process ``TrainStep`` losses against JAX ``TrainStep``;
- one 4-rank gloo spawn over ``create_mesh({"dp": 2, "sp": 2})``
  (``data_spec=PartitionSpec("dp", "sp")``, ``sequence_parallel="sp"``):
  its losses against the JAX single-device losses, its all-reduced
  step-1 gradients and its parameters after three steps against the
  port's single-process run, rtol 1e-4 (atol 1e-6: f32 sums in other
  orders; the JAX SP test, ``test_dist_parity.py:75``, uses rtol 2e-3;
  the key bias, whose true gradient is 0, within its Adam bound of
  3 lr); every rank holds the same parameters bit for bit; attention
  dropout under the ring raises.
"""
import numpy as np
import pytest
import torch

import _torch_sp_ranks as ranks
import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.nn.transformer import MultiHeadAttention as JMHA
from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         load_numpy_state)
from paddle_tpu_torch.optimizer import AdamW

B, L, STEPS, LR = 4, 64, 3, 1e-3


def _jax_model():
    paddle.seed(0)
    jm = JGPT(JGPTConfig.tiny())
    return jm, {k: v.numpy() for k, v in jm.state_dict().items()}


def _port_model(state):
    tm = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    load_numpy_state(tm, state)
    return tm


def _ids(seed=0):
    return np.random.RandomState(seed).randint(0, 128, (B, L)) \
        .astype(np.int64)


def test_state_dict_keys_and_shapes_match_the_jax_model():
    jm, state = _jax_model()
    tm = _port_model(state)
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in state.items()}
    assert len(state) == 36


def test_forward_and_loss_match_jax():
    jm, state = _jax_model()
    tm = _port_model(state)
    ids = _ids()
    jl = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    tl = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(tl.detach().numpy(), jl, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm.loss(torch.from_numpy(ids)).item(),
                               float(jm.loss(paddle.to_tensor(ids)).numpy()),
                               rtol=1e-6)


def test_causal_attention_with_a_key_mask_matches_jax():
    """Causal MHA with a (B, 1, 1, L) key-padding mask: the JAX layer
    folds the two into one mask, the port rides the kernel with both."""
    paddle.seed(1)
    jmha = JMHA(32, 4, is_causal=True)
    tmha = nn.MultiHeadAttention(32, 4, is_causal=True, device="cpu")
    load_numpy_state(tmha, {k: v.numpy()
                            for k, v in jmha.state_dict().items()})
    rng = np.random.RandomState(2)
    x = rng.randn(2, 16, 32).astype(np.float32)
    mask = (np.arange(16)[None, :] < np.array([16, 9])[:, None])
    mask = mask[:, None, None, :]
    jout = jmha(paddle.to_tensor(x), attn_mask=paddle.to_tensor(mask))
    tout = tmha(torch.from_numpy(x), attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(),
                               atol=1e-5, rtol=0)


def test_causal_attention_with_a_per_query_mask_raises():
    """Folding the causal constraint into a per-query mask, or into any
    mask at Lq != Lk, raised until the decoder's slice; now the port folds
    as the JAX layer does (bottom-right aligned) and runs the counted
    per-query plain route: a (B, 1, L, L) bool mask, and a (B, 1, 1, Lk)
    key mask at Lq != Lk, each within atol 1e-5 of the JAX layer."""
    from paddle_tpu_torch.ops.cuda import counters

    paddle.seed(1)
    jmha = JMHA(32, 4, is_causal=True)
    tmha = nn.MultiHeadAttention(32, 4, is_causal=True, device="cpu")
    load_numpy_state(tmha, {k: v.numpy()
                            for k, v in jmha.state_dict().items()})
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, 32).astype(np.float32)
    kv = rng.randn(2, 8, 32).astype(np.float32)
    per_query = rng.rand(2, 1, 16, 16) < 0.8
    per_query[..., 0] = True
    key8 = (np.arange(8)[None, :] < np.array([8, 5])[:, None])[:, None, None]
    counters.reset()
    for args, mask in (((x,), per_query), ((x, kv, kv), key8)):
        jout = jmha(*(paddle.to_tensor(a) for a in args),
                    attn_mask=paddle.to_tensor(mask))
        tout = tmha(*(torch.from_numpy(a) for a in args),
                    attn_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(),
                                   atol=1e-5, rtol=0)
    assert counters.get("attention_per_query_plain") == 2


def _jax_losses(state):
    jm, _ = _jax_model()
    step = JTrainStep(jm, lambda m, x: m.loss(x),
                      jopt.AdamW(learning_rate=LR, parameters=jm.parameters(),
                                 weight_decay=0.01))
    ids = paddle.to_tensor(_ids())
    return np.array([float(step(ids).numpy()) for _ in range(STEPS)])


def _port_run(state):
    tm = _port_model(state)
    step = TrainStep(tm, lambda m, x: m.loss(x),
                     AdamW(learning_rate=LR, parameters=tm.parameters(),
                           weight_decay=0.01))
    ids = torch.from_numpy(_ids())
    losses, grads = [], None
    for i in range(STEPS):
        losses.append(float(step(ids)))
        if i == 0:
            grads = {n: p.grad.numpy().copy()
                     for n, p in tm.named_parameters()}
    return np.array(losses), grads, \
        {n: p.detach().numpy() for n, p in tm.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's losses, the port's single-process run and one 4-rank
    dp x sp run of the same steps."""
    _, state = _jax_model()
    path = tmp_path_factory.mktemp("gpt_sp") / "rendezvous"
    sp = spawn(ranks.gpt_sp_rank,
               args=({"dp": 2, "sp": 2}, GPTConfig.tiny(), state, _ids(),
                     STEPS, LR),
               nprocs=4, init_method=f"file://{path}", timeout=120)
    return _jax_losses(state), _port_run(state), sp


def test_train_step_losses_match_jax(runs):
    jl, (tl, _, _), _ = runs
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_dp_sp_losses_match_jax_single_device(runs):
    jl, _, sp = runs
    for rank in range(4):                 # every rank reports the global loss
        np.testing.assert_allclose(sp[rank]["losses"], jl, rtol=1e-4)


def test_dp_sp_step_one_gradients_match_single_process(runs):
    """The all-reduced step-1 gradients of every rank against the
    single-process ones (atol 1e-6: the key bias's true gradient is 0)."""
    _, (_, grads, _), sp = runs
    assert [r["coords"] for r in sp] == [{"dp": 0, "sp": 0},
                                         {"dp": 0, "sp": 1},
                                         {"dp": 1, "sp": 0},
                                         {"dp": 1, "sp": 1}]
    for rank in range(4):
        got = sp[rank]["grads"]
        assert set(got) == set(grads)
        for name, want in grads.items():
            np.testing.assert_allclose(got[name], want, rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {rank} {name}")


def test_dp_sp_parameters_match_single_process(runs):
    """Every parameter after three steps, rtol 1e-4. The key projection's
    bias has an exactly-zero true gradient: Adam's m / sqrt(v) turns the
    last-bit noise there into steps of up to lr of either sign, so that
    bias is held to its bound, STEPS * lr, instead."""
    _, (_, _, params), sp = runs
    for rank in range(4):
        got = sp[rank]["params"]
        assert set(got) == set(params)
        for name, want in params.items():
            if name.endswith("k_proj.bias"):
                np.testing.assert_allclose(got[name], want, rtol=0,
                                           atol=STEPS * LR)
            else:
                np.testing.assert_allclose(got[name], want, rtol=1e-4,
                                           atol=1e-6,
                                           err_msg=f"rank {rank} {name}")
        for name in params:       # the ranks hold one model, bit for bit
            np.testing.assert_array_equal(got[name], sp[0]["params"][name])


def test_attention_dropout_under_sequence_parallel_raises(runs):
    _, _, sp = runs
    assert all(r["dropout_raises"] for r in sp)


def test_train_step_refuses_tensor_parallel_and_zero():
    tm = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    opt = AdamW(learning_rate=LR, parameters=tm.parameters())
    with pytest.raises(NotImplementedError, match="11b"):
        TrainStep(tm, lambda m, x: m.loss(x), opt, param_rules={})
    with pytest.raises(NotImplementedError, match="slice 9"):
        TrainStep(tm, lambda m, x: m.loss(x), opt, zero_stage=1)
