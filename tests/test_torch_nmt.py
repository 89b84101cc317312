"""The port's Transformer NMT (paddle_tpu_torch: models.transformer,
nn.Transformer and its decoder, ops.beam_search, attention's mask
dispatch) held against the JAX package on the CPU.

A tiny NMT (vocabularies 64, d_model 32, 4 heads, 2 + 2 layers, ffn 64,
dropout 0), batch 2 x 16. The JAX model is built from
``paddle_tpu.seed(0)`` and its ``state_dict()`` is carried into the port
by path (``load_numpy_state``); ids are numpy from a seed. On the CPU the
port's kernels run their plain versions and the JAX side its XLA paths
(at length 16 JAX attention takes ``_xla_attention``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.framework.flags import set_flags as jset_flags
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.transformer import TransformerNMT as JNMT
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import fused_xent  # noqa: F401 (defines the flag)
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.framework.flags import set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.transformer import (TransformerNMT,
                                                 load_numpy_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.optimizer import Adam

V, D_MODEL, HEADS, FFN, B, S = 64, 32, 4, 64, 2, 16
CFG = dict(src_vocab_size=V, tgt_vocab_size=V, d_model=D_MODEL, nhead=HEADS,
           num_encoder_layers=2, num_decoder_layers=2, dim_feedforward=FFN,
           dropout=0.0, max_len=64)


def _models(random_scale=0.0):
    """The JAX model and the port's with its weights. With
    ``random_scale`` every weight is N(0, random_scale^2) from a numpy
    seed (norm scales 1 + that) in both: the tiny model's own
    initialisation repeats its last input token when decoding, these
    weights pick varied tokens."""
    paddle.seed(0)
    jm = JNMT(**CFG)
    if random_scale:
        rng = np.random.RandomState(11)
        jm.set_state_dict({
            k: (rng.randn(*v.shape) * random_scale
                + (1.0 if "norm" in k and k.endswith("weight") else 0.0)
                ).astype(np.float32)
            for k, v in jm.state_dict().items()})
    state = {k: v.numpy() for k, v in jm.state_dict().items()}
    tm = TransformerNMT(**CFG, device="cpu")
    load_numpy_state(tm, state)
    return jm, tm


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randint(3, V, (B, S)).astype(np.int32)
    tgt_in = rng.randint(3, V, (B, S)).astype(np.int32)
    tgt_out = rng.randint(3, V, (B, S)).astype(np.int32)
    tgt_out[:, -3:] = 0                      # padding, ignored by the loss
    return src, tgt_in, tgt_out


def _jax(batch):
    return [paddle.to_tensor(x) for x in batch]


def _torch(batch):
    return [torch.from_numpy(x) for x in batch]


@pytest.fixture(autouse=True)
def _fresh():
    counters.reset()
    yield
    counters.reset()
    set_flags({"fused_vocab_xent": True})
    jset_flags({"fused_vocab_xent": True})


def test_state_dict_keys_and_shapes_match_the_jax_model():
    jm, tm = _models()
    js = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    ts = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert js == ts
    assert "pos.pe" not in ts and len(ts) == 2 + 2 * 16 + 2 * 26 + 2


def test_forward_logits_match_jax():
    """f32 logits within atol 1e-5 (summation order only)."""
    jm, tm = _models()
    src, tgt_in, _ = _batch()
    jl = jm(*_jax((src, tgt_in))).numpy()
    tl = tm(*_torch((src, tgt_in))).detach().numpy()
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "logits"])
def test_both_loss_arms_match_jax_and_each_other(fused):
    """``FLAGS_fused_vocab_xent`` on (the fused kernel's plain version,
    W transposed to (V, H)) and off (``out_proj`` + ``F.cross_entropy``):
    each within rtol 1e-5 of the JAX arm, and of the other arm."""
    jm, tm = _models()
    batch = _batch()
    set_flags({"fused_vocab_xent": fused})
    jset_flags({"fused_vocab_xent": fused})
    tl = float(tm.loss(*_torch(batch)))
    np.testing.assert_allclose(tl, float(jm.loss(*_jax(batch)).numpy()),
                               rtol=1e-5)
    set_flags({"fused_vocab_xent": not fused})
    np.testing.assert_allclose(float(tm.loss(*_torch(batch))), tl, rtol=1e-5)


def _steps(level, dtype, n):
    jm, tm = _models()

    def jloss(m, *a):
        with jamp.auto_cast(enable=level != "O0", level=level, dtype=dtype):
            return m.loss(*a)

    def tloss(m, *a):
        with amp.auto_cast(enable=level != "O0", level=level, dtype=dtype):
            return m.loss(*a)

    jstep = JTrainStep(jm, jloss, jopt.Adam(learning_rate=1e-3,
                                            parameters=jm.parameters()))
    tstep = TrainStep(tm, tloss, Adam(learning_rate=1e-3,
                                      parameters=tm.parameters()))
    batch = _batch()
    jl = [float(jstep(*_jax(batch)).numpy()) for _ in range(n)]
    tl = [float(tstep(*_torch(batch))) for _ in range(n)]
    return np.array(jl), np.array(tl)


def test_o0_three_adam_steps_match_jax():
    """f32 throughout: three Adam steps through ``TrainStep`` give the
    JAX losses within rtol 1e-4, falling."""
    jl, tl = _steps("O0", "bfloat16", 3)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_o0_step_one_gradients_match_jax():
    """Every gradient of the loss at the carried-over weights, within
    atol 1e-5 + rtol 1e-4 (f32; summation order only)."""
    jm, tm = _models()
    batch = _batch()
    jm.train()
    jl = jm.loss(*_jax(batch))
    jl.backward()
    tl = tm.loss(*_torch(batch))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), rtol=1e-5)
    jgrads = {n: p.grad.numpy() for n, p in jm.named_parameters()}
    tgrads = dict(tm.named_parameters())
    assert set(jgrads) == set(tgrads)
    for name, g in jgrads.items():
        np.testing.assert_allclose(tgrads[name].grad.numpy(), g, atol=1e-5,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("dtype,rtol", [("bfloat16", 2e-2),
                                        ("float16", 5e-3)],
                         ids=["bf16", "fp16"])
def test_o1_two_steps_match_jax(dtype, rtol):
    """AMP O1: linear layers in the low type, norms and losses in f32,
    attention over the projections' type (the port's plain version keeps
    P in f32, JAX's XLA path rounds it to the type), so two losses agree
    to rtol 2e-2 in bf16 and 5e-3 in f16 (f16 keeps 3 more bits)."""
    jl, tl = _steps("O1", dtype, 2)
    np.testing.assert_allclose(tl, jl, rtol=rtol)


def test_o1_fp16_attention_runs_in_f16():
    """Under ``auto_cast(dtype="float16")`` attention receives f16 q, k, v
    from the f16 projections (``sdpa`` is on neither AMP list) and gives
    f16 out: the kernels' f16 form on the card."""
    _, tm = _models()
    seen = []
    real = tfa.flash_attention

    def spy(q, k, v, **kw):
        seen.append(q.dtype)
        return real(q, k, v, **kw)

    tfa.flash_attention = spy
    try:
        with amp.auto_cast(level="O1", dtype="float16"):
            tm.loss(*_torch(_batch()))
    finally:
        tfa.flash_attention = real
    assert seen == [torch.float16] * 6


def test_greedy_decode_ids_equal_jax():
    jm, tm = _models(random_scale=0.5)
    src = _batch(2)[0][:, :10]
    jids = np.asarray(jm.greedy_decode(paddle.to_tensor(src),
                                       max_len=6).numpy())
    tids = tm.greedy_decode(torch.from_numpy(src), max_len=6).numpy()
    assert len(set(tids.ravel().tolist())) >= 3     # bos and two tokens
    np.testing.assert_array_equal(tids, jids)


def test_beam_search_ids_equal_jax_and_scores_within_1e5():
    """Beam 3, max_len 10: the same ids (best beam first) and
    length-normalised scores within atol 1e-5 (f32 sums of log-probs)."""
    jm, tm = _models(random_scale=0.5)
    src = _batch(1)[0][:, :10]
    jids, jsc = jm.beam_search_decode(paddle.to_tensor(src), beam_size=3,
                                      max_len=10)
    tids, tsc = tm.beam_search_decode(torch.from_numpy(src), beam_size=3,
                                      max_len=10)
    assert tids.dtype == torch.int32 and tuple(tids.shape) == (B, 3, 10)
    np.testing.assert_array_equal(tids.numpy(), jids.numpy())
    np.testing.assert_allclose(tsc.numpy(), jsc.numpy(), atol=1e-5, rtol=0)


def _spy_flash(monkeypatch):
    calls = []
    real = tfa.flash_attention

    def spy(q, k, v, causal=False, dropout_p=0.0, seed=0, bias=None):
        calls.append({"causal": causal, "bias": bias is not None,
                      "lq": q.shape[1], "lk": k.shape[1]})
        return real(q, k, v, causal=causal, dropout_p=dropout_p, seed=seed,
                    bias=bias)

    monkeypatch.setattr(tfa, "flash_attention", spy)
    return calls


def test_subsequent_mask_runs_the_causal_kernel(monkeypatch):
    """The NMT's decoder self-attention mask reaches the flash wrapper as
    ``causal=True`` with no bias (a spy on the wrapper), no attention
    call takes the per-query plain route, and the logits equal, within
    atol 1e-6, those of the same model whose masks are untagged copies
    (which run the per-query route and add the mask's -1e9)."""
    _, tm = _models()
    src, tgt_in, _ = _torch(_batch())
    calls = _spy_flash(monkeypatch)
    out = tm(src, tgt_in).detach()
    assert [c["causal"] for c in calls] == [False, False, True, False,
                                            True, False]
    assert not any(c["bias"] for c in calls)
    assert counters.get("attention_per_query_plain") == 0
    real_gen = nn.Transformer.generate_square_subsequent_mask
    monkeypatch.setattr(nn.Transformer, "generate_square_subsequent_mask",
                        staticmethod(lambda n, d=None: real_gen(n, d)
                                     .clone()))
    ref = tm(src, tgt_in).detach()
    assert counters.get("attention_per_query_plain") == 2
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)


def test_a_changed_subsequent_mask_is_a_per_query_mask():
    """An in-place change drops the tag: the mask is then attention's
    per-query kind (and its new values count)."""
    mask = nn.Transformer.generate_square_subsequent_mask(8, "cpu")
    assert F.is_subsequent_mask(mask, 8, 8)
    assert not F.is_subsequent_mask(mask, 8, 4)
    mask[0, 1] = 0.0
    assert not F.is_subsequent_mask(mask, 8, 8)
    q = torch.randn(1, 8, 2, 64)
    F.scaled_dot_product_attention(q, q, q, attn_mask=mask)
    assert counters.get("attention_per_query_plain") == 1


def test_decoder_memory_key_padding_rides_the_masked_kernel(monkeypatch):
    """A (B, 1, 1, S) boolean ``memory_mask`` reaches cross-attention as
    the flash kernels' key bias; the decoder agrees with JAX's within
    atol 1e-5."""
    paddle.seed(1)
    jdec = jnn.TransformerDecoder(
        jnn.TransformerDecoderLayer(D_MODEL, HEADS, FFN, dropout=0.0), 2)
    tdec = nn.TransformerDecoder(
        nn.TransformerDecoderLayer(D_MODEL, HEADS, FFN, dropout=0.0,
                                   device="cpu"), 2)
    load_numpy_state(tdec, {k: v.numpy()
                            for k, v in jdec.state_dict().items()})
    rng = np.random.RandomState(4)
    tgt = rng.randn(B, 12, D_MODEL).astype(np.float32)
    mem = rng.randn(B, S, D_MODEL).astype(np.float32)
    mask = (np.arange(S)[None, :] < np.array([S, 9])[:, None])[:, None, None]
    causal = jnn.Transformer.generate_square_subsequent_mask(12)
    want = jdec(paddle.to_tensor(tgt), paddle.to_tensor(mem), causal,
                paddle.to_tensor(mask)).numpy()
    calls = _spy_flash(monkeypatch)
    got = tdec(torch.from_numpy(tgt), torch.from_numpy(mem),
               nn.Transformer.generate_square_subsequent_mask(12, "cpu"),
               torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5,
                               rtol=0)
    assert [(c["causal"], c["bias"], c["lq"], c["lk"]) for c in calls] == \
        [(True, False, 12, 12), (False, True, 12, S)] * 2
    assert counters.get("attention_per_query_plain") == 0


@pytest.mark.parametrize("kind", ["float_b1qk", "bool_qk", "float_grad"])
def test_other_masks_take_the_counted_plain_route(kind, monkeypatch):
    """A per-query mask (and a float key mask that requires grad) runs
    ``per_query_attention``, counted once a call, never the kernels'
    wrapper, and equals ``_xla_attention`` within atol 1e-5; a float
    mask that requires grad gets its gradient."""
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(2, 16, 2, 64).astype(np.float32) for _ in range(3))
    k, v = k[:, :12], v[:, :12]
    if kind == "float_b1qk":
        mask = (rng.randn(2, 1, 16, 12) * 2).astype(np.float32)
    elif kind == "bool_qk":
        mask = rng.rand(16, 12) < 0.7
        mask[:, 0] = True
    else:
        mask = (rng.randn(2, 12) * 2).astype(np.float32)
    jmask = mask[:, None, None, :] if kind == "float_grad" else mask
    want = jfa._xla_attention(*(paddle.to_tensor(x).value
                                for x in (q, k, v)),
                              paddle.to_tensor(jmask).value, 0.0, False,
                              None)
    calls = _spy_flash(monkeypatch)
    tmask = torch.tensor(mask, requires_grad=kind == "float_grad")
    out = F.scaled_dot_product_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), attn_mask=tmask)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    assert calls == [] and counters.get("attention_per_query_plain") == 1
    if kind == "float_grad":
        out.sum().backward()
        assert tmask.grad is not None and tmask.grad.abs().sum() > 0


def test_bert_materialised_loss_arm_matches_jax():
    """``FLAGS_fused_vocab_xent`` off in the port's BERT: ``forward``'s
    logits through ``F.cross_entropy``, within rtol 1e-5 of the JAX
    model's arm and of the fused arm (tiny BERT, 1 layer, batch 2 x 32,
    dropout 0)."""
    from paddle_tpu.models.bert import BertConfig as JCfg
    from paddle_tpu.models.bert import BertForPretraining as JBert
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining

    def cfg(c):
        c.num_hidden_layers = 1
        c.hidden_dropout_prob = c.attention_probs_dropout_prob = 0.0
        return c

    paddle.seed(0)
    jm = JBert(cfg(JCfg.tiny()))
    tm = BertForPretraining(cfg(BertConfig.tiny()), device="cpu")
    load_numpy_state(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    rng = np.random.RandomState(6)
    ids = rng.randint(0, 1024, (2, 32)).astype(np.int32)
    tt = np.zeros((2, 32), np.int32)
    mlm = np.where(rng.rand(2, 32) < 0.3, ids, -100).astype(np.int32)
    nsp = np.array([0, 1], np.int32)
    batch = (ids, tt, mlm, nsp)
    fused = float(tm.loss(*_torch(batch)))
    set_flags({"fused_vocab_xent": False})
    jset_flags({"fused_vocab_xent": False})
    tl = float(tm.loss(*_torch(batch)))
    np.testing.assert_allclose(tl, float(jm.loss(*_jax(batch)).numpy()),
                               rtol=1e-5)
    np.testing.assert_allclose(tl, fused, rtol=1e-5)


@pytest.mark.parametrize("length_penalty", [0.6, 0.0])
def test_beam_search_decode_with_state_matches_jax(length_penalty):
    """``ops.beam_search_decode`` alone, against the JAX function on the
    same logits: a table lookup by the last token plus a per-row state
    that counts the steps and is reordered with the beams (the default
    ``gather_state_fn``); EOS freezing (token 2 is likely), the GNMT
    length penalty on and off. Ids equal, scores within atol 1e-5."""
    import jax.numpy as jnp

    from paddle_tpu.ops.beam_search import beam_search_decode as jbeam
    from paddle_tpu_torch.ops.beam_search import beam_search_decode

    rng = np.random.RandomState(8)
    table = (rng.randn(V, V) * 3).astype(np.float32)
    table[:, 2] += 2.0
    batch, beam, max_len = 3, 4, 9

    def make(xp, take):
        def logits_fn(ids, t, state):
            last = ids[:, t]
            return take(table, last) + state[:, None] * 0.1, state + 1.0
        return logits_fn

    jids, jsc = jbeam(make(jnp, lambda tb, i: jnp.asarray(tb)[i]),
                      batch_size=batch, beam_size=beam, max_len=max_len,
                      length_penalty=length_penalty,
                      state=jnp.arange(batch * beam, dtype=jnp.float32))
    tids, tsc = beam_search_decode(
        make(torch, lambda tb, i: torch.from_numpy(tb)[i.long()]),
        batch_size=batch, beam_size=beam, max_len=max_len,
        length_penalty=length_penalty,
        state=torch.arange(batch * beam, dtype=torch.float32))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), atol=1e-5,
                               rtol=0)
    assert (tids.numpy() == 2).any()
