"""The port's ring attention (paddle_tpu_torch/parallel/ring.py) and K1's
external-lse backward (``flash_attention_bwd_ext``) held against the JAX
package on the CPU, from the same numpy inputs.

- The external-lse plain version against JAX ``_bwd_call`` in interpret
  mode, for one kv chunk with the lse and delta of a longer sequence
  (B 1, L 128, H 2, D 64, and H 1 at D 192 and 256; causal and not,
  with and without a key bias); f32, atol 1e-5 (the sums run in another
  order).
- The in-process ring (``ring_attention_chunks``, every rank's walk in
  one process) against ``_xla_attention``: forward and the gradients of
  a weighted sum, 2 and 4 chunks, causal, full and key-padded; atol 1e-5.
- One 4-rank gloo spawn (``distributed.spawn``, ``file://`` rendezvous
  under ``tmp_path``) of the port's global ``ring_attention`` on
  ``create_mesh({"sp": 4})``: causal, full and key-padded (the last kv
  block masked on every row, so every rank skips it), forward and
  gradients against ``_xla_attention`` and against JAX ``ring_attention``
  on ``create_mesh({"sp": 4})`` (its CPU einsum walk) at the same numpy
  inputs, atol 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sp_ranks as ranks
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import ring as jring
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.parallel.ring import ring_attention_chunks

ATOL = 1e-5


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run pallas_call in interpret mode so the JAX kernels run on CPU."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(real, interpret=True))


def _heads(x):
    b, l, h, d = x.shape
    return jnp.asarray(np.swapaxes(x, 1, 2).reshape(b * h, l, d))


@pytest.mark.parametrize("D", [64, 192, 256])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ext_backward_plain_matches_pallas_bwd_call(interpret_pallas,
                                                    causal, bias, D):
    rng = np.random.RandomState(3)
    B, L, H = 1, 128, 2 if D == 64 else 1
    q, k, v, do, k2, v2 = (rng.randn(B, L, H, D).astype(np.float32)
                           for _ in range(6))
    mb = np.where(rng.rand(B, L) < 0.8, 0.0, -1e30).astype(np.float32) \
        if bias else None
    # the global statistics: this chunk and another one before it
    t = torch.tensor
    kk, vv = t(np.concatenate([k2, k], 1)), t(np.concatenate([v2, v], 1))
    gb = None if mb is None else t(np.concatenate(
        [np.zeros((B, L), np.float32), mb], 1))
    out, lse = tfa._plain_fwd(t(q), kk, vv, False, 0.0, 0, gb)
    delta = (t(do) * out).sum(-1).permute(0, 2, 1).reshape(B * H, L)
    dq, dk, dv = tfa.flash_attention_bwd_ext(
        t(q), t(k), t(v), t(do), lse, delta.contiguous(), causal,
        None if mb is None else t(mb))
    jdq, jdk, jdv = jfa._bwd_call(
        _heads(q), _heads(k), _heads(v), _heads(do),
        jnp.asarray(lse.numpy())[:, None, :],
        jnp.asarray(delta.numpy())[:, None, :], causal, 128, 128,
        1.0 / np.sqrt(D), mask_bias=None if mb is None
        else jnp.asarray(mb)[:, None, :], heads=H)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        want = np.swapaxes(np.asarray(want).reshape(B, H, L, D), 1, 2)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert counters.get("flash_attention_ext_bwd") == 0   # the CPU: plain


def _xla(q, k, v, causal, lens):
    mask = None if lens is None else jnp.asarray(
        np.arange(q.shape[1])[None, None, None, :]
        < np.asarray(lens)[:, None, None, None])
    return jfa._xla_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), mask, 0.0, causal, None)


def _xla_with_grads(q, k, v, w, causal, lens):
    out, vjp = jax.vjp(lambda a, b, c: _xla(a, b, c, causal, lens), q, k, v)
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(w)))]


def _case(name, seed, B=2, L=64, H=2, D=16):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.randn(B, L, H, D).astype(np.float32)
                  for _ in range(4))
    causal = "causal" in name
    lens = [40, 20] if "padded" in name else None   # block 3 dead on both
    return name, q, k, v, w, causal, lens


CASES = ["causal", "full", "padded", "padded_causal"]


@pytest.mark.parametrize("chunks", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_chunk_merge_matches_xla_attention(name, chunks):
    _, q, k, v, w, causal, lens = _case(name, 11)
    want = _xla_with_grads(q, k, v, w, causal, lens)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    mask = None if lens is None else \
        torch.arange(q.shape[1])[None, :] < torch.tensor(lens)[:, None]
    out = ring_attention_chunks(tq, tk, tv, chunks, causal, kv_mask=mask)
    (out * torch.tensor(w)).backward(torch.ones_like(out))
    for got, ref in zip((out, tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=ATOL,
                                   rtol=0)


@pytest.fixture(scope="module")
def ring4(tmp_path_factory):
    """One 4-rank gloo run of every case; ranks' results by rank."""
    cases = [_case(name, 20 + i) for i, name in enumerate(CASES)]
    path = tmp_path_factory.mktemp("ring4") / "rendezvous"
    got = spawn(ranks.ring_rank, args=(4, cases), nprocs=4,
                init_method=f"file://{path}", timeout=120)
    return {c[0]: c for c in cases}, got


@pytest.mark.parametrize("name", CASES)
def test_ring_attention_4_ranks_matches_xla_attention(ring4, name):
    cases, got = ring4
    _, q, k, v, w, causal, lens = cases[name]
    want = _xla_with_grads(q, k, v, w, causal, lens)
    for rank in range(4):           # global in, global out on every rank
        for x, ref in zip(got[rank][name], want):
            np.testing.assert_allclose(x, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", CASES)
def test_ring_attention_4_ranks_matches_jax_ring(ring4, name):
    cases, got = ring4
    _, q, k, v, w, causal, lens = cases[name]
    prev = jmesh.get_mesh()
    try:
        mesh = jmesh.create_mesh({"sp": 4})
        mask = None if lens is None else jnp.asarray(
            np.arange(q.shape[1])[None, :] < np.asarray(lens)[:, None])

        @jax.jit
        def f(a, b, c, cot):
            out, vjp = jax.vjp(lambda a_, b_, c_: jring.ring_attention(
                a_, b_, c_, mesh=mesh, is_causal=causal, kv_mask=mask),
                a, b, c)
            return (out, *vjp(cot))

        want = [np.asarray(x) for x in f(*map(jnp.asarray, (q, k, v, w)))]
    finally:
        jmesh.set_mesh(prev)
    for x, ref in zip(got[0][name], want):
        np.testing.assert_allclose(x, ref, atol=ATOL, rtol=0)


def test_size_one_axis_runs_the_local_kernel_with_the_jax_warning():
    """``ring_attention`` without a mesh, or with the axis at size 1, runs
    the local kernel and warns as ``ring.py:492-496`` does; no
    ``sequence_parallel`` scope is active on such a mesh."""
    from paddle_tpu_torch.parallel import (active_sequence_parallel,
                                           create_mesh, get_mesh,
                                           ring_attention, sequence_parallel,
                                           set_mesh)

    _, q, k, v, _, _, _ = _case("causal", 31)
    q, k, v = (torch.tensor(x) for x in (q, k, v))
    want = tfa.flash_attention(q, k, v, causal=True).numpy()
    prev = get_mesh()
    try:
        set_mesh(None)
        with pytest.warns(RuntimeWarning, match="no mesh axis 'sp'"):
            got = ring_attention(q, k, v, is_causal=True)
        np.testing.assert_array_equal(got.numpy(), want)
        mesh = create_mesh({"sp": 1})
        with pytest.warns(RuntimeWarning, match="'sp' has size 1"):
            got = ring_attention(q, k, v, mesh=mesh, is_causal=True)
        np.testing.assert_array_equal(got.numpy(), want)
        with sequence_parallel("sp", mesh=mesh):
            assert active_sequence_parallel() is None
    finally:
        set_mesh(prev)
