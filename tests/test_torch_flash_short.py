"""The short-sequence flash kernels' module (paddle_tpu_torch/ops/cuda/
flash_attention.py: ``flash_attention_short``, ``short_ok``) and the
dispatch in ``nn.functional.scaled_dot_product_attention``, held against
the JAX package on the CPU.

- K1c/K1d: the port's plain short forward and backward against
  ``_flash_attention_core_short`` with ``pl.pallas_call`` in interpret
  mode (as ``tests/test_flash_short.py`` runs it): b 2, L 128 and 256,
  h 2, d 64, and h 1 at d 192 and 256, f32, causal and not, no dropout;
  out within 2e-5, the gradients of ``sum(out**2)`` within 1e-4 (JAX's
  own tolerances).
- The routing rule: the same verdicts as ``_short_ok`` (with
  ``pallas_enabled`` patched True) on L 128 / 512 / 1024,
  cross-attention and head widths 64 to 320, and the flag's gate; the
  one intended difference is the dropped ``b*h < 2**15`` bound. At head
  widths 192 and 256 and lengths that are not multiples of 128 (200,
  320) the short kernels refuse and the flag's dispatch runs the
  streaming form, whose output and gradients (h 1, causal and not) are
  held against JAX's ``_flash_attention_core`` in interpret mode with
  one block over the whole length (2e-5 and 1e-4).

On the CPU the wrappers run their plain versions; the CUDA kernels are
held against those and against the streaming kernel on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch import get_flags, set_flags
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.ops.cuda import flash_attention as tfa


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


@pytest.fixture
def short_flag():
    prev = get_flags("flash_short_seq")
    yield
    set_flags(prev)


def _qkv(b=2, l=128, h=2, d=64, seed=0, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, l, h, d).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("d", [64, 192, 256])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("l", [128, 256])
def test_short_forward_matches_the_pallas_short_kernel(causal, l, d):
    q, k, v = _qkv(l=l, h=2 if d == 64 else 1, d=d, seed=l)
    jout, res = jfa._flash_attention_core_short_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, causal, 0.0)
    jlse = np.asarray(res[4])[:, 0, :]                # (B*H, L)
    out, lse = tfa.flash_attention_short_fwd(torch.tensor(q),
                                             torch.tensor(k),
                                             torch.tensor(v), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=2e-5, atol=2e-5)
    assert counters.snapshot() == {}                  # the CPU runs plain


@pytest.mark.parametrize("d", [64, 192, 256])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("l", [128, 256])
def test_short_backward_matches_the_pallas_short_kernel(causal, l, d):
    """Gradients of ``sum(out**2)`` through the one-launch backward."""
    q, k, v = _qkv(l=l, h=2 if d == 64 else 1, d=d, seed=l + 1)

    def jloss(a, b, c):
        return jnp.sum(jfa._flash_attention_core_short(a, b, c, None,
                                                       causal, 0.0) ** 2)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (tfa.flash_attention_short(tq, tk, tv, causal=causal) ** 2).sum() \
        .backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_short_and_streaming_forms_agree_with_dropout():
    """The short and the streaming forms compute one function and key
    dropout by the same Philox coordinates: the same outputs and
    gradients for one seed."""
    q, k, v = _qkv(b=1, l=128, seed=5)
    outs, grads = [], []
    for fn in (tfa.flash_attention_short, tfa.flash_attention):
        tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
        out = fn(tq, tk, tv, dropout_p=0.1, seed=42)
        out.sum().backward()
        outs.append(out.detach())
        grads.append((tq.grad, tk.grad, tv.grad))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_short_ok_gives_the_jax_verdicts(monkeypatch):
    import paddle_tpu.framework.bringup as bringup

    monkeypatch.setattr(bringup, "pallas_enabled", lambda: True)
    shapes = [((2, 128, 2, 64), (2, 128, 2, 64)),
              ((2, 512, 2, 64), (2, 512, 2, 64)),
              ((2, 1024, 2, 64), (2, 1024, 2, 64)),
              ((2, 128, 2, 64), (2, 256, 2, 64)),      # cross-attention
              ((2, 192, 2, 64), (2, 192, 2, 64)),      # L % 128 != 0
              ((2, 64, 2, 64), (2, 64, 2, 64)),        # below 128
              ((1, 256, 4, 128), (1, 256, 4, 128)),
              ((1, 512, 4, 192), (1, 512, 4, 192)),    # head widths 192,
              ((1, 128, 3, 256), (1, 128, 3, 256)),    # 256: the kernels
              ((1, 128, 2, 96), (1, 128, 2, 96)),      # and JAX's refusals
              ((1, 128, 2, 320), (1, 128, 2, 320))]
    for qs, ks in shapes:
        jq, jk = jnp.zeros(qs), jnp.zeros(ks)
        for causal in (False, True):
            assert tfa.short_ok(torch.zeros(qs), torch.zeros(ks), causal) \
                == jfa._short_ok(jq, jk, causal), (qs, ks, causal)
    # the intended difference: no b*h < 2**15 bound
    big = (256, 128, 128, 64)                           # b*h = 2**15
    assert tfa.short_ok(torch.empty(big, device="meta"),
                        torch.empty(big, device="meta"))
    spec = jax.ShapeDtypeStruct(big, jnp.bfloat16)
    assert not jfa._short_ok(spec, spec, False)


def test_sdpa_routes_by_flag_and_shape(monkeypatch, short_flag):
    """``FLAGS_flash_short_seq`` off (the default, as in JAX): the
    streaming form; on: the short form where the shape fits and the
    streaming one elsewhere (L 1024, cross-attention)."""
    calls = []
    real_short, real_stream = tfa.flash_attention_short, tfa.flash_attention

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tfa, "flash_attention_short",
                        spy("short", real_short))
    monkeypatch.setattr(tfa, "flash_attention", spy("stream", real_stream))
    q128 = torch.zeros(1, 128, 1, 64)
    q1024 = torch.zeros(1, 1024, 1, 64)
    assert get_flags("flash_short_seq") == {"flash_short_seq": False}
    F.scaled_dot_product_attention(q128, q128, q128)
    set_flags({"flash_short_seq": True})
    F.scaled_dot_product_attention(q128, q128, q128, dropout_p=0.1)
    F.scaled_dot_product_attention(q1024, q1024, q1024)
    F.scaled_dot_product_attention(q128, torch.zeros(1, 256, 1, 64),
                                   torch.zeros(1, 256, 1, 64))
    assert calls == ["stream", "short", "stream", "stream"]


@pytest.mark.parametrize("d,l", [(192, 200), (256, 320)])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_wide_ragged_length_runs_the_streaming_form(monkeypatch, short_flag,
                                                    causal, d, l):
    """With the flag on, a wide head at a length the short kernels
    refuse (L % 128 != 0) takes the streaming form, and that matches the
    JAX kernel."""
    calls = []
    real_short, real_stream = tfa.flash_attention_short, tfa.flash_attention

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tfa, "flash_attention_short",
                        spy("short", real_short))
    monkeypatch.setattr(tfa, "flash_attention", spy("stream", real_stream))
    q, k, v, do = _qkv(b=1, l=l, h=1, d=d, seed=d + l, n=4)
    assert not tfa.short_ok(torch.tensor(q), torch.tensor(k), causal)
    set_flags({"flash_short_seq": True})
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(tq, tk, tv, is_causal=causal)
    out.backward(torch.tensor(do))
    assert calls == ["stream"]

    def jcore(a, b, c):
        return jfa._flash_attention_core(a, b, c, causal, l, l)

    jout, vjp = jax.vjp(jcore, jnp.asarray(q), jnp.asarray(k),
                        jnp.asarray(v))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=2e-5, atol=2e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


def test_short_form_refuses_other_shapes():
    x = torch.zeros(1, 64, 1, 64)
    with pytest.raises(ValueError, match="short flash"):
        tfa.flash_attention_short(x, x, x)
    with pytest.raises(KeyError):
        set_flags({"no_such_flag": True})
