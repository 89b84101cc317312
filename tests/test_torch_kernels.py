"""The port's kernel modules (paddle_tpu_torch/ops/cuda, ps/codec) held
against the JAX package on the CPU, from the same numpy inputs:

- the per-row int8 KV codec, bit for bit against jnp_encode_kv_rows;
- paged attention (f32 and int8 pools) against the XLA gather paths
  and the Pallas kernels in interpret mode, at the JAX suite's own
  tolerance (rtol/atol 2e-5), ragged lengths >= 1 with -1 table tails;
- the page-write scatters, equal to JAX's pools everywhere but the
  trash page 0 (duplicate writes land there in any order);
- fused sampling, bit for bit against _xla_sample under jax.jit (the
  engine's decode step) and against the Pallas kernel on tie-free
  rows, plus a tied row that pins the top-k rule.

On the CPU every wrapper runs its plain version; the CUDA kernels run
on the card only (tests/test_torch_cuda.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu.ops.pallas import sampling as jsm
from paddle_tpu.ps.codec import jnp_encode_kv_rows
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.ops.cuda import paged_attention as tpa
from paddle_tpu_torch.ops.cuda import sampling as tsm
from paddle_tpu_torch.ps.codec import decode_kv_rows, encode_kv_rows

ATOL = RTOL = 2e-5   # the JAX suite's kernel-vs-fallback tolerance


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    """Run pallas_call in interpret mode so the JAX kernels run on CPU."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(real, interpret=True))
    counters.reset()
    yield
    counters.reset()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,seed", [((64, 4, 8), 0), ((3, 5, 2, 16), 1),
                                        ((7, 16, 128), 2)])
def test_codec_rows_bitwise_match_jax(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * rng.uniform(0.01, 50, shape[:-2] + (1, 1))
         ).astype(np.float32)
    x.reshape((-1,) + shape[-2:])[0] = 0.0        # an all-zero row
    x.reshape(-1)[5] = 2.5 * x.reshape(-1)[5]     # halfway ties stay rare
    jq, js = jnp_encode_kv_rows(jnp.asarray(x))
    tq, ts = encode_kv_rows(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = decode_kv_rows(tq, ts).numpy()
    np.testing.assert_allclose(back, x, atol=float(np.abs(x).max()) / 127)


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------
def _attn_inputs(seed, b=3, h=2, d=16, s=8, pages=12, quant=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, d).astype(np.float32)
    if quant:
        kp = rng.randint(-127, 128, (pages, s, h, d)).astype(np.int8)
        vp = rng.randint(-127, 128, (pages, s, h, d)).astype(np.int8)
        ks = rng.uniform(0.001, 0.05, (pages, s)).astype(np.float32)
        vs = rng.uniform(0.001, 0.05, (pages, s)).astype(np.float32)
        return q, kp, vp, ks, vs
    kp = rng.randn(pages, s, h, d).astype(np.float32)
    vp = rng.randn(pages, s, h, d).astype(np.float32)
    return q, kp, vp, None, None


# ragged lengths >= 1 with -1 tails; the last case has a -1 INSIDE the
# live length, which reads page 0 in every implementation
_TABLES = [
    ([[1, 2, 3], [4, 5, -1], [6, -1, -1]], [20, 11, 5]),
    ([[7, 8, 9], [10, -1, -1], [11, 3, -1]], [1, 8, 9]),
    ([[1, -1, 4], [2, 5, -1], [3, -1, -1]], [24, 16, 8]),
]


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("case", range(len(_TABLES)))
def test_paged_attention_matches_xla_and_pallas(case, quant):
    q, kp, vp, ks, vs = _attn_inputs(case, quant=quant)
    table = np.asarray(_TABLES[case][0], np.int32)
    lens = np.asarray(_TABLES[case][1], np.int32)
    j = [jnp.asarray(a) for a in (q, kp, vp)]
    jt, jl = jnp.asarray(table), jnp.asarray(lens)
    if quant:
        jks, jvs = jnp.asarray(ks), jnp.asarray(vs)
        ref = jpa._xla_paged_attention_quant(*j, jks, jvs, jt, jl)
        pal = jpa._paged_attention_pallas_quant(*j, jks, jvs, jt, jl)
        out = tpa.paged_attention(_t(q), _t(kp), _t(vp), _t(table),
                                  _t(lens), k_scales=_t(ks),
                                  v_scales=_t(vs))
    else:
        ref = jpa._xla_paged_attention(*j, jt, jl)
        pal = jpa._paged_attention_pallas(*j, jt, jl)
        out = tpa.paged_attention(_t(q), _t(kp), _t(vp), _t(table),
                                  _t(lens))
    assert out.shape == (3, 2, 16) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(pal),
                               rtol=RTOL, atol=ATOL)
    # CPU tensors take the plain version: no kernel launch is counted
    assert counters.snapshot() == {}


def test_paged_attention_ignores_dead_page_contents():
    q, kp, vp, _, _ = _attn_inputs(5)
    table = np.asarray([[1, 2, -1], [3, -1, -1], [4, 5, 6]], np.int32)
    lens = np.asarray([10, 3, 24], np.int32)
    out1 = tpa.paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(lens))
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[7:], vp2[7:] = 1e4, 1e4
    out2 = tpa.paged_attention(_t(q), _t(kp2), _t(vp2), _t(table),
                               _t(lens))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# page writes (in place in the port, functional in JAX)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_write_matches_jax_outside_trash_page(quant):
    rng = np.random.RandomState(11)
    P, S, H, D = 10, 4, 2, 8
    kp = rng.randn(P, S, H, D).astype(np.float32)
    vp = rng.randn(P, S, H, D).astype(np.float32)
    ks = rng.rand(P, S).astype(np.float32)
    vs = rng.rand(P, S).astype(np.float32)
    if quant:
        kp = rng.randint(-127, 128, kp.shape).astype(np.int8)
        vp = rng.randint(-127, 128, vp.shape).astype(np.int8)
    table = np.asarray([[3, 4], [5, -1], [6, 7], [8, -1]], np.int32)
    positions = np.asarray([5, 2, 7, 6], np.int32)   # row 3 hits a -1
    active = np.asarray([True, True, False, True])
    nk = rng.randn(4, H, D).astype(np.float32)
    nv = rng.randn(4, H, D).astype(np.float32)
    tk, tv, tks, tvs = _t(kp.copy()), _t(vp.copy()), _t(ks.copy()), \
        _t(vs.copy())
    if quant:
        jk, jv, jks, jvs = jpa.paged_write_quant(
            jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ks),
            jnp.asarray(vs), jnp.asarray(table), jnp.asarray(positions),
            jnp.asarray(nk), jnp.asarray(nv), jnp.asarray(active))
        tpa.paged_write_quant(tk, tv, tks, tvs, _t(table), _t(positions),
                              _t(nk), _t(nv), _t(active))
        np.testing.assert_array_equal(tks.numpy()[1:], np.asarray(jks)[1:])
        np.testing.assert_array_equal(tvs.numpy()[1:], np.asarray(jvs)[1:])
    else:
        jk, jv = jpa.paged_write(
            jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
            jnp.asarray(positions), jnp.asarray(nk), jnp.asarray(nv),
            jnp.asarray(active))
        tpa.paged_write(tk, tv, _t(table), _t(positions), _t(nk), _t(nv),
                        _t(active))
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])
    assert not np.array_equal(tk.numpy()[4], kp[4])   # the write landed


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_prefill_write_matches_jax_outside_trash_page(quant):
    rng = np.random.RandomState(12)
    P, S, H, D = 9, 4, 2, 8
    dt = np.int8 if quant else np.float32
    kp = np.zeros((P, S, H, D), dt)
    vp = np.zeros((P, S, H, D), dt)
    ks = np.zeros((P, S), np.float32)
    vs = np.zeros((P, S), np.float32)
    ids = np.asarray([0, 5, 2], np.int32)   # a shared page routed at 0
    nk = rng.randn(3 * S, H, D).astype(np.float32)
    nv = rng.randn(3 * S, H, D).astype(np.float32)
    tk, tv, tks, tvs = _t(kp.copy()), _t(vp.copy()), _t(ks.copy()), \
        _t(vs.copy())
    if quant:
        jk, jv, jks, jvs = jpa.paged_prefill_write_quant(
            *(jnp.asarray(a) for a in (kp, vp, ks, vs, ids, nk, nv)))
        tpa.paged_prefill_write_quant(tk, tv, tks, tvs, _t(ids), _t(nk),
                                      _t(nv))
        np.testing.assert_array_equal(tks.numpy()[1:], np.asarray(jks)[1:])
        np.testing.assert_array_equal(tvs.numpy()[1:], np.asarray(jvs)[1:])
    else:
        jk, jv = jpa.paged_prefill_write(
            *(jnp.asarray(a) for a in (kp, vp, ids, nk, nv)))
        tpa.paged_prefill_write(tk, tv, _t(ids), _t(nk), _t(nv))
    np.testing.assert_array_equal(tk.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(tv.numpy()[1:], np.asarray(jv)[1:])


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def _rows(b=4, v=256, seed=0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(b, v) * 3).astype(np.float32)
    noise = rng.gumbel(size=(b, v)).astype(np.float32)
    return logits, noise


_jit_sample = jax.jit(jsm._xla_sample, static_argnums=(2, 3, 4))


@pytest.mark.parametrize("temperature", [0.7, 1.0, 1.7])
@pytest.mark.parametrize("top_k", [0, 1, 4, 8])
def test_sampling_bitwise_matches_jitted_xla_sample(top_k, temperature):
    logits, noise = _rows(b=8, v=1000, seed=top_k)
    ref = np.asarray(_jit_sample(jnp.asarray(logits), jnp.asarray(noise),
                                 temperature, top_k, 1.0))
    out = tsm.fused_sample(_t(logits), _t(noise), temperature, top_k)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("top_k", [0, 1, 4, 8])
def test_sampling_matches_pallas_kernel_on_tie_free_rows(top_k):
    logits, noise = _rows(seed=10 + top_k)
    assert len(np.unique(logits)) == logits.size
    pal = np.asarray(jsm._fused_sample_pallas(
        jnp.asarray(logits), jnp.asarray(noise), 0.7, top_k))
    out = tsm.fused_sample(_t(logits), _t(noise), 0.7, top_k)
    np.testing.assert_array_equal(out.numpy(), pal)


def test_sampling_top_k_counts_duplicates():
    """Tied logits: the k-th largest value counts duplicates, as
    lax.top_k gives it. With three tied maxima and k=2, only the tied
    three survive; the Pallas kernel's rule (every element equal to the
    max leaves in one round) also keeps the runner-up."""
    logits = np.full((1, 128), -5.0, np.float32)
    logits[0, [3, 9, 40]] = 5.0
    logits[0, 77] = 1.0
    noise = np.zeros((1, 128), np.float32)
    noise[0, 77] = 50.0            # drowns the gap if index 77 survives
    ref = np.asarray(_jit_sample(jnp.asarray(logits), jnp.asarray(noise),
                                 1.0, 2, 1.0))
    out = tsm.fused_sample(_t(logits), _t(noise), 1.0, 2)
    assert out.numpy().tolist() == ref.tolist() == [3]
    pal = np.asarray(jsm._fused_sample_pallas(
        jnp.asarray(logits), jnp.asarray(noise), 1.0, 2))
    assert pal.tolist() == [77]


def test_sampling_greedy_and_top_p_legs():
    logits, noise = _rows(seed=3)
    out = tsm.fused_sample(_t(logits), _t(noise * 100), 0.0)
    np.testing.assert_array_equal(out.numpy(), logits.argmax(-1))
    ref = np.asarray(_jit_sample(jnp.asarray(logits), jnp.asarray(noise),
                                 0.8, 4, 0.9))
    out = tsm.fused_sample(_t(logits), _t(noise), 0.8, 4, top_p=0.9)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert counters.snapshot() == {"fused_sample.top_p_plain": 1}
