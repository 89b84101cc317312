"""Key-padding masks through the port's flash attention (the masked form
of K1a/K1b; paddle_tpu_torch: ops/cuda/flash_attention,
nn.functional.scaled_dot_product_attention, models.bert) held against
the JAX package on the CPU, from the same numpy inputs.

- The masked plain forward and backward against
  ``_flash_attention_pallas_masked`` in interpret mode (a (B, Lk) f32
  bias from ``_kv_mask_bias``), causal and not, f32 at atol 1e-5 (the
  sums run in another order); and against ``_xla_attention`` with the
  (B, 1, 1, Lk) bool form.
- A batch whose every key is masked gives the mean of V (the finite
  -1e30 bias), never NaN; ``kv_mask_bias`` against ``_kv_mask_bias``.
- ``kv_tile_visits``, the bf16 forward's dead kv-tile rule: what it
  skips is dead and changes no bit of the plain forward.
- ``scaled_dot_product_attention``'s routing: bool and float
  key-padding masks ride the streaming kernel (with the short-sequence
  flag on too), per-query masks and float masks that require grad take
  the counted plain route (``per_query_attention``), and
  dropout with a mask equals the dense formula built from
  ``philox_keep_mask`` (values and autograd gradients).
- A tiny masked BERT (``BertConfig.tiny()``, weights carried across,
  dropout 0, a (B, 1, 1, L) bool mask, -100 labels at padding): three
  O0 AdamW losses and the step-1 gradients against JAX.
On the CPU every wrapper runs its plain version; the kernels are held
against it on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBert
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch import get_flags, set_flags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                          load_numpy_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.optimizer import AdamW

ATOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    """Run pallas_call in interpret mode so the JAX kernels run on CPU."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(real, interpret=True))
    counters.reset()
    yield
    assert counters.snapshot() == {}                  # the CPU runs plain


def _qkv(b=2, l=256, h=2, d=64, seed=0, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, l, h, d).astype(np.float32) for _ in range(n)]


def _padding_mask(l, lens):
    m = np.zeros((len(lens), l), bool)
    for i, n in enumerate(lens):
        m[i, :n] = True
    return m


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_masked_forward_matches_pallas(causal):
    q, k, v = _qkv(seed=1)
    mask = _padding_mask(256, [256, 150])
    jbias = jfa._kv_mask_bias(jnp.asarray(mask), 2, 256)
    want = jfa._flash_attention_pallas_masked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jbias, causal=causal)
    bias = tfa.kv_mask_bias(torch.tensor(mask), 2, 256)
    out, lse = tfa.flash_attention_fwd(_t(q), _t(k), _t(v), causal, 0.0, 0,
                                       bias)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert torch.isfinite(lse).all()


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_dead_kv_tiles_the_bf16_forward_skips_change_no_bit(causal):
    """``kv_tile_visits``, the bf16 forward's dead-tile rule: every tile it
    skips is dead (all keys -1e30), every row of a q tile that skips
    keeps a live allowed key in a visited tile, and scoring the skipped
    keys -inf instead of -1e30 leaves the plain forward's bits; an entry
    with no live key and causal rows before the first live key visit
    every tile. Not causal, against ``_flash_attention_pallas_masked``."""
    B, L, H, D = 4, 256, 2, 64
    q, k, v = (_t(a) for a in _qkv(b=B, l=L, h=H, d=D, seed=6))
    col = torch.arange(L)[None, :]
    live = (col >= torch.tensor([[0], [100], [0], [200]])) \
        & (col < torch.tensor([[97], [256], [0], [256]]))
    bias = tfa.kv_mask_bias(live, B, L)
    full = tfa.kv_tile_visits(B, L, L, causal)
    visits = tfa.kv_tile_visits(B, L, L, causal, bias)
    skipped = full & ~visits
    assert int(skipped.sum()) > 0 and bool((visits <= full).all())
    assert torch.equal(visits[2], full[2])          # no live key at all
    if causal:
        assert torch.equal(visits[3], full[3])      # first live key 200
    row = torch.arange(L)[:, None]
    allowed = (col <= row) if causal else torch.ones(L, L, dtype=torch.bool)
    drop = torch.zeros(B, L, L, dtype=torch.bool)   # skipped (row, key)
    for b, qt, t in torch.nonzero(skipped).tolist():
        assert not live[b, 64 * t:64 * t + 64].any()
        drop[b, 64 * qt:64 * qt + 64, 64 * t:64 * t + 64] = True
    for b, qt in torch.nonzero(skipped.any(-1)).tolist():
        rows = slice(64 * qt, 64 * qt + 64)
        assert (live[b][None, :] & allowed[rows] & ~drop[b, rows]).any(-1) \
            .all()
    scale = 1.0 / math.sqrt(D)
    qm, km, vm = (x.permute(0, 2, 1, 3).reshape(B * H, L, D)
                  for x in (q, k, v))
    s = tfa._scores(qm, km, scale, causal, bias)
    cut = s.masked_fill(drop.repeat_interleave(H, 0), float("-inf"))
    out, out_cut = (torch.softmax(x, -1) @ vm for x in (s, cut))
    assert torch.equal(out.view(torch.int32), out_cut.view(torch.int32))
    if not causal:
        want = jfa._flash_attention_pallas_masked(
            *(jnp.asarray(x.numpy()) for x in (q, k, v)),
            jfa._kv_mask_bias(jnp.asarray(live.numpy()), B, L))
        got = out.reshape(B, H, L, D).permute(0, 2, 1, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_masked_backward_matches_pallas_vjp(causal):
    q, k, v, do = _qkv(seed=2, n=4)
    mask = _padding_mask(256, [224, 97])
    jbias = jfa._kv_mask_bias(jnp.asarray(mask), 2, 256)
    _, vjp = jax.vjp(lambda a, b, c: jfa._flash_attention_pallas_masked(
        a, b, c, jbias, causal=causal), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    bias = tfa.kv_mask_bias(torch.tensor(mask), 2, 256)
    tfa.flash_attention(tq, tk, tv, causal=causal, bias=bias).backward(
        _t(do))
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)


def test_masked_matches_xla_attention_with_the_4d_bool_form():
    q, k, v, do = _qkv(b=3, l=128, seed=3, n=4)
    mask = _padding_mask(128, [128, 70, 1])
    m4 = mask[:, None, None, :]

    def jloss(a, b, c):
        out = jfa._xla_attention(a, b, c, jnp.asarray(m4), 0.0, False, None)
        return jnp.sum(out * jnp.asarray(do)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = F.scaled_dot_product_attention(tq, tk, tv,
                                         attn_mask=torch.tensor(m4))
    (out * _t(do)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL, rtol=0)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)


def test_a_fully_masked_batch_gives_the_mean_of_v():
    q, k, v = _qkv(l=256, seed=4)
    mask = _padding_mask(256, [256, 0])
    jbias = jfa._kv_mask_bias(jnp.asarray(mask), 2, 256)
    want = np.asarray(jfa._flash_attention_pallas_masked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jbias))
    out = F.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                         attn_mask=torch.tensor(mask))
    assert torch.isfinite(out).all()
    mean_v = v[1].mean(axis=0, keepdims=True)           # (1, H, D)
    np.testing.assert_allclose(out.numpy()[1], np.broadcast_to(
        mean_v, out.shape[1:]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=0)


def test_kv_mask_bias_matches_jax():
    """``tests/test_flash_attention.py::test_kv_mask_bias_shapes``'s
    shapes, and the values of every key-padding form."""
    mask = _padding_mask(256, [256, 31])
    for m in (mask, mask[:, None, :], mask[:, None, None, :]):
        want = jfa._kv_mask_bias(jnp.asarray(m), 2, 256)
        got = tfa.kv_mask_bias(torch.tensor(m), 2, 256)
        assert got.shape == (2, 256) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    per_q = np.ones((2, 1, 256, 256), bool)
    assert jfa._kv_mask_bias(jnp.asarray(per_q), 2, 256) is None
    assert tfa.kv_mask_bias(torch.tensor(per_q), 2, 256) is None
    add = np.zeros((2, 256), np.float32)
    assert jfa._kv_mask_bias(jnp.asarray(add), 2, 256) is None
    assert tfa.kv_mask_bias(torch.tensor(add), 2, 256) is None


def test_a_float_key_mask_is_added_to_the_scores():
    q, k, v = _qkv(l=128, seed=5)
    rng = np.random.RandomState(6)
    fmask = (rng.randn(2, 1, 1, 128) * 2).astype(np.float32)
    fmask[1, ..., 100:] = -1e30
    want = jfa._xla_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(fmask), 0.0, False,
                              None)
    for m in (fmask, fmask[:, 0, 0], fmask[:, 0]):
        out = F.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                             attn_mask=torch.tensor(m))
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)


def test_masks_the_kernel_does_not_take_raise():
    """The masks no kernel takes raised until the decoder's slice; now
    each runs the per-query plain route, counted once a call (the values
    are held against ``_xla_attention`` in tests/test_torch_nmt.py). The
    short kernels still refuse a key mask."""
    from paddle_tpu_torch.ops.cuda import counters

    q = torch.zeros((2, 128, 2, 64))
    counters.reset()
    for mask in (torch.ones((2, 1, 128, 128), dtype=torch.bool),
                 torch.ones((128, 128), dtype=torch.bool),
                 torch.zeros((2, 1, 128, 128)),
                 torch.zeros((2, 128), requires_grad=True)):
        out = F.scaled_dot_product_attention(q, q, q, attn_mask=mask)
        assert out.shape == q.shape
    assert counters.get("attention_per_query_plain") == 4
    counters.reset()
    bias = torch.zeros((2, 128))
    with pytest.raises(ValueError, match="no key mask"):
        tfa.flash_attention_short(q, q, q, bias=bias)
    with pytest.raises(ValueError, match="no key mask"):
        tfa.flash_attention_short_fwd(q, q, q, bias=bias)


def test_a_masked_call_takes_the_streaming_kernel_with_the_short_flag(
        monkeypatch):
    q, k, v = (_t(x) for x in _qkv(l=128, seed=7))
    mask = torch.tensor(_padding_mask(128, [128, 50]))

    def refuse(*a, **kw):
        raise AssertionError("a masked call reached the short kernels")

    monkeypatch.setattr(tfa, "flash_attention_short", refuse)
    prev = get_flags("flash_short_seq")
    set_flags({"flash_short_seq": True})
    try:
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        with pytest.raises(AssertionError, match="short kernels"):
            F.scaled_dot_product_attention(q, k, v)
    finally:
        set_flags(prev)
    want = tfa.flash_attention(q, k, v, bias=tfa.kv_mask_bias(mask, 2, 128))
    assert torch.equal(out, want)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_dropout_with_a_mask_is_the_dense_formula(causal):
    """softmax(s + bias), the Philox keep mask scaled by 1/(1-p), times
    V; gradients through autograd of that dense formula (f64). The
    forward agrees to 1e-10; the gradients to 1e-6, because the saved
    lse is f32 (the kernels' layout) and the backward's P carries its
    rounding."""
    B, L, H, D, p, seed = 2, 128, 2, 64, 0.2, 4242
    q, k, v, do = (x.astype(np.float64) for x in _qkv(B, L, H, D, 8, 4))
    mask = torch.tensor(_padding_mask(L, [L, 77]))
    bias = tfa.kv_mask_bias(mask, B, L)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tfa.flash_attention(tq, tk, tv, causal=causal, dropout_p=p,
                              seed=seed, bias=bias)
    out.backward(_t(do))

    dq, dk, dv = _t(q, True), _t(k, True), _t(v, True)
    s = torch.einsum("bqhd,bkhd->bhqk", dq, dk) / math.sqrt(D)
    s = s + bias.double()[:, None, None, :]
    if causal:
        s = s.masked_fill(torch.ones(L, L, dtype=torch.bool).triu(1),
                          float("-inf"))
    keep = tfa.philox_keep_mask(seed, B * H, L, L, p).view(B, H, L, L)
    prob = torch.where(keep, torch.softmax(s, -1) / (1 - p), 0.0)
    dense = torch.einsum("bhqk,bkhd->bqhd", prob, dv)
    dense.backward(_t(do))
    np.testing.assert_allclose(out.detach().numpy(), dense.detach().numpy(),
                               atol=1e-10, rtol=0)
    for got, want in ((tq, dq), (tk, dk), (tv, dv)):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   atol=1e-6, rtol=0)
    assert 0.75 < float(keep.double().mean()) < 0.85


# ---------------------------------------------------------------------------
# a tiny masked BERT against JAX
# ---------------------------------------------------------------------------
B, L = 2, 128
LENS = (100, 57)


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
    valid = _padding_mask(L, LENS)
    ids = np.where(valid, rng.randint(0, vocab, (B, L)), 0).astype(np.int32)
    tt = (rng.rand(B, L) < 0.5).astype(np.int32) * valid
    mlm = rng.randint(0, vocab, (B, L)).astype(np.int32)
    mlm[rng.rand(B, L) < 0.85] = -100
    mlm[~valid] = -100                              # no loss at padding
    nsp = rng.randint(0, 2, (B,)).astype(np.int32)
    return ids, tt, mlm, nsp, valid[:, None, None, :]


def test_tiny_masked_bert_three_o0_losses_match_jax():
    jm, tm = _models()
    jstep = JTrainStep(jm, lambda m, *a: m.loss(*a),
                       jopt.AdamW(learning_rate=1e-3,
                                  parameters=jm.parameters(),
                                  weight_decay=0.01))
    tstep = TrainStep(tm, lambda m, *a: m.loss(*a),
                      AdamW(learning_rate=1e-3, parameters=tm.parameters(),
                            weight_decay=0.01))
    batch = _batch()
    jargs = [paddle.to_tensor(x) for x in batch]
    targs = [torch.from_numpy(x) for x in batch]
    jl = [float(jstep(*jargs).numpy()) for _ in range(3)]
    tl = [float(tstep(*targs)) for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_tiny_masked_bert_step_one_gradients_match_jax():
    jm, tm = _models()
    batch = _batch(seed=1)
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
    # the mask matters: the same batch without it gives another loss
    with torch.no_grad():
        nomask = tm.loss(*[torch.from_numpy(x) for x in batch[:4]])
    assert abs(nomask.item() - tl.item()) > 1e-3
