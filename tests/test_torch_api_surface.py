"""The port's public surface against the JAX package's frozen one, and
attention's shape route against JAX's Pallas gate.

``API.spec`` (read here, never written) freezes every public callable of
``paddle_tpu`` with its signature. Each ``paddle_tpu.<name>``,
``paddle_tpu.ops.<name>`` and ``paddle_tpu.autograd.<name>`` entry must
have a ``paddle_tpu_torch`` counterpart with the same parameter names,
order and defaults (a class's ``__init__``), but for ``LATER``: names a
later slice ports, each with its ROADMAP item. That list may only
shrink. ``API.spec`` has no ``paddle_tpu.tensor.`` rows, so the public
callables of ``paddle_tpu.tensor`` are held the same way by
``inspect.signature``.
"""
import inspect
import pathlib

import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.tensor as jt
import paddle_tpu_torch as tp
import paddle_tpu_torch.tensor as tt
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

SPEC = pathlib.Path(__file__).resolve().parent.parent / "API.spec"

_SEQ = "ROADMAP queue 1 item 3 (slice 10: ops/sequence.py)"
_LOD = "ROADMAP queue 1 item 3 (slice 10: framework/lod.py)"
LATER = {
    **{f"{m}sequence_{n}": _SEQ for m in ("", "ops.")
       for n in ("conv", "expand", "first_step", "last_step", "pad",
                 "pool", "reverse", "softmax", "unpad")},
    "LoDTensor.__init__": _LOD,
    "create_lod_tensor": _LOD,
    "create_random_int_lodtensor": _LOD,
    "batch": "ROADMAP queue 1 item 3 (slice 10: reader)",
    "summary": "ROADMAP queue 1 item 3 (slice 10: hapi)",
    "Model.__init__": "ROADMAP queue 1 item 3 (slice 10: hapi)",
}


def _entries():
    out = []
    for line in SPEC.read_text().splitlines():
        name = line.split(" ", 1)[0]
        for prefix in ("paddle_tpu.ops.", "paddle_tpu.autograd.",
                       "paddle_tpu."):
            if name.startswith(prefix):
                rest = name[len("paddle_tpu."):]
                if prefix == "paddle_tpu." and "." in rest and not \
                        rest.endswith(".__init__"):
                    break
                if rest.count(".") > (2 if prefix != "paddle_tpu." else 1):
                    break
                out.append(rest)
                break
    return out


ENTRIES = _entries()


def _resolve(root, dotted):
    obj = root
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def _params(fn):
    sig = inspect.signature(fn)
    return [(p.name, p.kind.name,
             "<none>" if p.default is inspect.Parameter.empty
             else _norm_default(p.default))
            for p in sig.parameters.values()]


def _norm_default(v):
    """Defaults compared by value; a dtype default by its name (the JAX
    package's ``np.int64`` is the port's ``np.int64`` too)."""
    if isinstance(v, type) and issubclass(v, np.generic):
        return np.dtype(v).name
    return repr(v)


def test_the_spec_has_the_entries_in_scope():
    assert len(ENTRIES) >= 600, len(ENTRIES)
    assert set(LATER) <= set(ENTRIES)


@pytest.mark.parametrize("name", [e for e in ENTRIES if e not in LATER])
def test_every_spec_entry_has_its_counterpart_with_the_same_signature(name):
    want = _resolve(jp, name)
    got = _resolve(tp, name)
    assert _params(got) == _params(want)


@pytest.mark.parametrize("name", sorted(LATER))
def test_later_slice_names_are_not_claimed(name):
    """A name of ``LATER`` is not on the port's surface yet; porting it
    means deleting it from ``LATER``."""
    with pytest.raises(AttributeError):
        _resolve(tp, name)


TENSOR_NAMES = sorted(
    n for n in dir(jt) if not n.startswith("_") and callable(getattr(jt, n))
    and not isinstance(getattr(jt, n), type)
    and n not in LATER and getattr(getattr(jt, n), "__module__", "")
    .startswith("paddle_tpu"))


@pytest.mark.parametrize("name", TENSOR_NAMES)
def test_every_tensor_namespace_name_has_its_counterpart(name):
    want, got = getattr(jt, name), getattr(tt, name)
    try:
        w = _params(want)
    except (TypeError, ValueError):
        pytest.skip(f"paddle_tpu.tensor.{name} has no signature")
    assert _params(got) == w


# -- attention's shape route (satellite of the head-width repair) ------------
SHAPES = [(b, lq, lk, h, d, causal)
          for b in (1,) for h in (2,)
          for lq, lk in ((128, 128), (256, 256), (512, 512), (256, 512),
                         (384, 384), (300, 300), (8192, 8192))
          for d in (16, 32, 48, 64, 96, 128, 160, 192, 256, 320)
          for causal in (False, True)]


@pytest.mark.parametrize("shape", SHAPES, ids=[
    "x".join(str(v) for v in s[:5]) + ("c" if s[5] else "")
    for s in SHAPES])
def test_attention_route_follows_jax_gate(shape, monkeypatch):
    """Where JAX's ``_pallas_ok`` refuses a shape for its head width or
    for causal Lq != Lk, the port computes it outside the kernels too
    (``plain``); every head width JAX admits (64, 128, 192, 256) takes
    the kernel at every length (JAX's length floor and modulus are not
    copied), and no admitted width raises."""
    import jax.numpy as jnp

    monkeypatch.setattr("paddle_tpu.framework.bringup.pallas_enabled",
                        lambda: True)
    b, lq, lk, h, d, causal = shape
    q = jnp.zeros((b, lq, h, d), jnp.float32)
    k = jnp.zeros((b, lk, h, d), jnp.float32)
    jax_ok = jfa._pallas_ok(q, k, causal)
    head_or_causal_refused = d % 64 != 0 or d > 256 or (causal
                                                        and lq != lk)
    if head_or_causal_refused:
        assert not jax_ok
        assert tfa.attention_route(q.shape, k.shape, causal) == "plain"
    else:
        assert tfa.attention_route(q.shape, k.shape, causal) == "kernel"


def test_a_head_width_the_kernels_lack_runs_the_counted_plain_route():
    """Head width 16 (``translate_beam.py``'s NMT): ``plain_attention``,
    counted ``attention_plain`` once a call, equal to JAX's
    ``_xla_attention`` within 1e-5, with a causal and a key-padding
    form; the flash wrapper is never called."""
    import jax.numpy as jnp
    import torch

    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.cuda import counters

    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 6, 4, 16).astype(np.float32) for _ in range(3))
    keep = np.ones((2, 6), bool)
    keep[1, 4:] = False
    counters.reset()
    calls = []
    real = tfa.flash_attention
    tfa.flash_attention = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        for causal, mask in ((False, None), (True, None),
                             (False, torch.from_numpy(keep))):
            out = F.scaled_dot_product_attention(
                *(torch.from_numpy(x) for x in (q, k, v)), attn_mask=mask,
                is_causal=causal)
            jmask = None if mask is None else jnp.asarray(
                keep[:, None, None, :])
            want = jfa._xla_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jmask, 0.0, causal,
                                      None)
            np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=0)
    finally:
        tfa.flash_attention = real
    assert calls == []
    assert counters.get("attention_plain") == 3
    assert counters.get("attention_per_query_plain") == 0
    counters.reset()
