"""The port's embedding bag (paddle_tpu_torch: ops/cuda/fused_embedding,
nn.functional.fused_embedding_seq_pool and embedding, nn.Embedding,
incubate.layers.fused_embedding_seq_pool) held against the JAX package on
the CPU, from the same numpy inputs.

- The plain bag against ``_xla_bag`` (sum, mean, sqrtn) and against
  ``_bag_pallas`` in interpret mode (f32 and a bf16 table), its
  gradients through autograd against ``jax.grad`` of ``_bag_core``; f32
  at rtol/atol 1e-5 (the sums run in another order), bf16 within one
  bf16 ulp (both sum in f32 and round once).
- Bags that are all padding, and ids >= V (read as row V - 1, as
  ``_xla_bag``'s gather clamps; both JAX backward forms drop them).
- Both entries' padding and mean rules as written: the functional mean
  divides by the valid count, the incubate layer's by L (3.0 and 6.0
  pinned on ids [[1, 2, 0, 0]], padding_idx 0), ``lengths=``, the
  negative ``padding_idx`` and negative-id wrap, a created weight.
- ``nn.Embedding(padding_idx)`` against the JAX layer with the weights
  carried across.
On the CPU every wrapper runs its plain version (no launch is counted);
the kernel is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate import layers as jlayers
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import fused_embedding as jfe
from paddle_tpu_torch import incubate, nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layer import load_numpy_state
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.ops.cuda import fused_embedding as tfe

ATOL = RTOL = 1e-5
COMBINERS = ("sum", "mean", "sqrtn")


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    """Run pallas_call in interpret mode so the JAX kernel runs on CPU."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(real, interpret=True))
    counters.reset()
    yield
    assert counters.snapshot() == {}                  # the CPU runs plain


def _data(b=8, s=12, v=64, d=32, seed=0, pad_frac=0.3):
    rng = np.random.RandomState(seed)
    table = rng.randn(v, d).astype(np.float32)
    ids = rng.randint(0, v, (b, s)).astype(np.int32)
    ids[rng.rand(b, s) < pad_frac] = -1
    return table, ids


def _bf16_ulp(x):
    """One bf16 ulp at each element's magnitude (8 significant bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.where(x == 0, 2.0 ** -133, np.ldexp(1.0, e - 8))


@pytest.mark.parametrize("combiner", COMBINERS)
def test_plain_bag_matches_xla_bag(combiner):
    table, ids = _data()
    want = jfe._xla_bag(jnp.asarray(table), jnp.asarray(ids), combiner)
    got = tfe.fused_embedding_bag(torch.tensor(table), torch.tensor(ids),
                                  combiner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("combiner", COMBINERS)
def test_plain_bag_matches_the_pallas_kernel(combiner):
    table, ids = _data(seed=1)
    want = jfe._bag_pallas(jnp.asarray(table), jnp.asarray(ids), combiner)
    got = tfe._plain_bag(torch.tensor(table), torch.tensor(ids), combiner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("combiner", COMBINERS)
def test_bf16_table_within_one_ulp_of_the_pallas_kernel(combiner):
    table, ids = _data(seed=2)
    jt = jnp.asarray(table, jnp.bfloat16)
    want = np.asarray(jfe._bag_pallas(jt, jnp.asarray(ids), combiner)
                      .astype(jnp.float32))
    tt = torch.tensor(table).to(torch.bfloat16)
    got = tfe._plain_bag(tt, torch.tensor(ids), combiner)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= _bf16_ulp(want)).all(), float(err.max())


@pytest.mark.parametrize("combiner", COMBINERS)
def test_gradient_matches_bag_core(combiner):
    table, ids = _data(seed=3)
    jids = jnp.asarray(ids)
    jg = jax.grad(lambda t: jnp.sum(jfe._bag_core(t, jids, combiner) ** 2))(
        jnp.asarray(table))
    tt = torch.tensor(table, requires_grad=True)
    (tfe.fused_embedding_bag(tt, torch.tensor(ids), combiner) ** 2).sum() \
        .backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("combiner", COMBINERS)
def test_all_padded_bags_give_zero(combiner):
    table, ids = _data(seed=4)
    ids[1] = -1
    ids[5] = -7
    got = tfe._plain_bag(torch.tensor(table), torch.tensor(ids), combiner)
    want = jfe._bag_pallas(jnp.asarray(table), jnp.asarray(ids), combiner)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got[[1, 5]].numpy(), 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_ids_past_the_table_read_its_last_row():
    """``_xla_bag``'s gather clamps an id >= V to V - 1 (and counts it);
    its gradient, in both JAX backward forms, drops that id."""
    table, ids = _data(v=16, seed=5)
    ids[0, :3] = [16, 40, 15]
    ids[2, 0] = 1 << 30
    for combiner in COMBINERS:
        want = jfe._xla_bag(jnp.asarray(table), jnp.asarray(ids), combiner)
        tt = torch.tensor(table, requires_grad=True)
        got = tfe.fused_embedding_bag(tt, torch.tensor(ids), combiner)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL, err_msg=combiner)
        (got ** 2).sum().backward()
        jg = jax.grad(lambda t: jnp.sum(
            jfe._bag_core(t, jnp.asarray(ids), combiner) ** 2))(
                jnp.asarray(table))
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg),
                                   rtol=RTOL, atol=ATOL, err_msg=combiner)
    np.testing.assert_allclose(
        tfe._plain_bag(torch.tensor(table), torch.tensor(ids[:1, :3]),
                       "sum").numpy()[0],
        table[15] * 3, rtol=RTOL)


def test_int64_ids_and_f64_table_for_gradient_checks():
    table, ids = _data(b=3, s=5, v=10, d=4, seed=6)
    t64 = torch.tensor(table, dtype=torch.float64, requires_grad=True)
    ids64 = torch.tensor(ids, dtype=torch.int64)
    for combiner in COMBINERS:
        assert torch.autograd.gradcheck(
            lambda t: tfe.fused_embedding_bag(t, ids64, combiner), (t64,))


def test_functional_entry_padding_and_grad_match_jax():
    table, ids = _data(pad_frac=0.0, seed=7)
    ids[0, :2] = 7
    ids[3, :] = 7                                       # a whole padded bag
    ids[4, 1] = -2                                      # a negative id drops
    for combiner in COMBINERS:
        jt = paddle.to_tensor(table)
        jt.stop_gradient = False
        jout = JF.fused_embedding_seq_pool(jt, paddle.to_tensor(ids),
                                           combiner=combiner, padding_idx=7)
        (jout * jout).sum().backward()
        tt = torch.tensor(table, requires_grad=True)
        tout = F.fused_embedding_seq_pool(tt, torch.tensor(ids),
                                          combiner=combiner, padding_idx=7)
        (tout * tout).sum().backward()
        np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=combiner)
        np.testing.assert_allclose(tt.grad.numpy(), jt.grad.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=combiner)


def test_unknown_combiner_raises_before_dispatch():
    table, ids = _data()
    with pytest.raises(ValueError, match="unknown combiner"):
        F.fused_embedding_seq_pool(torch.tensor(table), torch.tensor(ids),
                                   combiner="max")
    with pytest.raises(ValueError, match="unknown combiner"):
        JF.fused_embedding_seq_pool(paddle.to_tensor(table),
                                    paddle.to_tensor(ids), combiner="max")


def test_the_two_entries_pool_mean_as_written():
    """ROADMAP queue 3: the functional mean divides by the valid count
    (6.0), the incubate layer's mean without lengths by L (3.0)."""
    w = np.arange(40, dtype=np.float32).reshape(10, 4)
    ids = np.array([[1, 2, 0, 0]], np.int64)
    tf = F.fused_embedding_seq_pool(torch.tensor(w), torch.tensor(ids),
                                    combiner="mean", padding_idx=0)
    ti = incubate.layers.fused_embedding_seq_pool(
        torch.tensor(ids), (10, 4), padding_idx=0, combiner="mean",
        weight=torch.tensor(w))
    jf = JF.fused_embedding_seq_pool(paddle.to_tensor(w),
                                     paddle.to_tensor(ids), combiner="mean",
                                     padding_idx=0)
    ji = jlayers.fused_embedding_seq_pool(
        paddle.to_tensor(ids), (10, 4), padding_idx=0, combiner="mean",
        weight=paddle.to_tensor(w))
    assert float(tf[0, 0]) == float(jf.numpy()[0, 0]) == 6.0
    assert float(ti[0, 0]) == float(ji.numpy()[0, 0]) == 3.0


@pytest.mark.parametrize("combiner,padding_idx,with_lengths", [
    ("sum", None, False), ("sum", 0, False), ("sum", -1, False),
    ("sum", 3, True), ("mean", 0, False), ("avg", None, False),
    ("mean", -10, True), ("avg", 2, True),
], ids=["sum", "sum-pad0", "sum-pad-neg", "sum-lengths", "mean-pad0",
        "avg", "mean-pad-neg-lengths", "avg-lengths"])
def test_incubate_entry_matches_jax(combiner, padding_idx, with_lengths):
    rng = np.random.RandomState(8)
    V, D = 10, 6
    w = rng.randn(V, D).astype(np.float32)
    ids = rng.randint(-V, V, (5, 7)).astype(np.int64)   # negatives wrap
    ids[1, 2:] = 0
    ids[2, :] = V - 1
    lengths = np.array([7, 2, 0, 4, 5], np.int64)
    kw = dict(padding_idx=padding_idx, combiner=combiner)
    jw = paddle.to_tensor(w)
    jw.stop_gradient = False
    jl = paddle.to_tensor(lengths) if with_lengths else None
    jout = jlayers.fused_embedding_seq_pool(paddle.to_tensor(ids), (V, D),
                                            weight=jw, lengths=jl, **kw)
    (jout * jout).sum().backward()
    tw = torch.tensor(w, requires_grad=True)
    tl = torch.tensor(lengths) if with_lengths else None
    tout = incubate.layers.fused_embedding_seq_pool(
        torch.tensor(ids), (V, D), weight=tw, lengths=tl, **kw)
    (tout * tout).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tw.grad.numpy(), jw.grad.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_incubate_entry_rejects_other_combiners():
    ids = torch.tensor([[1, 2]])
    w = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="unsupported combiner"):
        incubate.layers.fused_embedding_seq_pool(ids, (4, 2), weight=w,
                                                 combiner="sqrtn")
    with pytest.raises(ValueError, match="unsupported combiner"):
        jlayers.fused_embedding_seq_pool(paddle.to_tensor([[1, 2]]), (4, 2),
                                         weight=paddle.to_tensor(
                                             np.zeros((4, 2), np.float32)),
                                         combiner="sqrtn")


def test_incubate_entry_creates_a_trainable_table():
    ids = torch.tensor([[1, 2], [3, 0]])
    gen = torch.Generator().manual_seed(5)
    pooled, w = incubate.layers.fused_embedding_seq_pool(
        ids, (10, 4), device="cpu", generator=gen)
    assert isinstance(w, torch.nn.Parameter) and w.requires_grad
    assert w.shape == (10, 4) and w.dtype == torch.float32
    assert pooled.shape == (2, 4)
    torch.testing.assert_close(pooled[0], w[1] + w[2])
    assert 0.005 < float(w.detach().std()) < 0.02      # normal x 0.01
    again, w2 = incubate.layers.fused_embedding_seq_pool(
        ids, (10, 4), device="cpu",
        generator=torch.Generator().manual_seed(5))
    assert torch.equal(w, w2)
    pooled.sum().backward()
    assert float(w.grad[1].sum()) == 4.0


def test_embedding_padding_idx_matches_the_jax_layer():
    paddle.seed(0)
    jemb = paddle.nn.Embedding(12, 5, padding_idx=-2)
    assert np.all(jemb.weight.numpy()[10] == 0.0)
    temb = nn.Embedding(12, 5, padding_idx=-2, device="cpu")
    assert torch.all(temb.weight[10] == 0.0)
    load_numpy_state(temb, {k: v.numpy() for k, v in
                            jemb.state_dict().items()})
    with torch.no_grad():                               # a trained pad row
        temb.weight[10] = 1.0
    state = {k: v.detach().numpy() for k, v in temb.state_dict().items()}
    jemb.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    ids = np.array([[10, 1, -1, 3], [10, 10, 0, 11]], np.int64)
    jout = jemb(paddle.to_tensor(ids))
    (jout * jout).sum().backward()
    tout = temb(torch.tensor(ids))
    (tout * tout).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tout.detach().numpy()[0, 0], 0.0)
    np.testing.assert_allclose(temb.weight.grad.numpy(),
                               jemb.weight.grad.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert float(temb.weight.grad[10].abs().sum()) == 0.0
