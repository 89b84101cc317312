"""K1a/K1b over f16 (AMP O1 fp16): the port's plain versions held against
the JAX package's Pallas kernels run over f16 inputs in interpret mode on
the CPU, the f16 dispatch (the short kernels under the short flag, as
for bf16) and the f16 forms' plain versions and counter names, and the
2-byte check that holds the card's f16 kernels
(``chip_smoke.flash_2byte_vs_plain``) against a model of their dS
rounding.

The JAX kernel computes in f32 whatever its input type and writes its
output in ``q.dtype`` (``flash_attention.py:65-67, 179-180, 318``), as
the plain version does, so the two differ by the f32 sums' order: each
f16 output within one f16 unit of its value plus 1e-5 of the largest.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch import set_flags
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


def _f16(rng, *shape, mul=1.0):
    return (rng.randn(*shape) * mul).astype(np.float16)


def _within_a_unit(got, want, what):
    """Each f16 element within one f16 unit at its magnitude plus 1e-5
    of the largest value."""
    got = torch.as_tensor(np.array(got)).float()
    want = torch.as_tensor(np.array(want)).float()
    ratio = cs.tolerance_ratio(torch, got.half(), want,
                               1e-5 * float(want.abs().max()))
    assert ratio <= 1.0, (what, ratio)


CASES = [(128, 128, False), (128, 128, True), (64, 128, False)]
IDS = ["full", "causal", "lq_ne_lk"]


@pytest.mark.parametrize("lq,lk,causal", CASES, ids=IDS)
def test_f16_forward_matches_pallas(lq, lk, causal):
    rng = np.random.RandomState(1)
    q, k, v = _f16(rng, 1, lq, 2, 64), _f16(rng, 1, lk, 2, 64), \
        _f16(rng, 1, lk, 2, 64)
    jout, res = jfa._flash_attention_core_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 64, 64)
    assert jout.dtype == jnp.float16
    out, lse = tfa.flash_attention_fwd(*(torch.from_numpy(x)
                                         for x in (q, k, v)), causal)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    _within_a_unit(out, jout, "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[4])[:, 0, :],
                               atol=1e-5, rtol=0)
    assert counters.snapshot() == {}                  # the CPU runs plain


@pytest.mark.parametrize("lq,lk,causal", CASES, ids=IDS)
def test_f16_backward_matches_pallas(lq, lk, causal):
    """dq, dk, dv from JAX's ``_bwd_call`` (through
    ``_flash_attention_core_bwd``) and the port's plain backward, both
    from JAX's out and lse, with dO at 2^15 times a unit gradient."""
    rng = np.random.RandomState(2)
    q, k, v = _f16(rng, 1, lq, 2, 64), _f16(rng, 1, lk, 2, 64), \
        _f16(rng, 1, lk, 2, 64)
    do = _f16(rng, 1, lq, 2, 64, mul=2.0 ** 15 / lq)
    jout, res = jfa._flash_attention_core_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, 64, 64)
    jgrads = jfa._flash_attention_core_bwd(causal, 64, 64, res,
                                           jnp.asarray(do))
    lse = torch.from_numpy(np.asarray(res[4])[:, 0, :].copy())
    grads = tfa.flash_attention_bwd(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(np.asarray(jout)), lse, torch.from_numpy(do),
        causal)
    for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        assert got.dtype == torch.float16 and want.dtype == jnp.float16
        _within_a_unit(got, want, name)


def test_f16_attention_takes_the_streaming_kernel_with_the_short_flag(
        monkeypatch):
    """The dispatch by shape, not type (this test's name is older than
    K1c/K1d's f16 forms; it held the streaming route for f16 while they
    were not ported): with ``FLAGS_flash_short_seq`` on, f16 attention at
    a shape the short kernels take runs them, as bf16 does and as JAX's
    ``_short_choice`` does for any type; off, or at a shape they refuse
    (L 64), the streaming kernel."""
    called = []
    for name in ("flash_attention", "flash_attention_short"):
        real = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, functools.partial(
            lambda real, name, *a, **kw: called.append(name) or real(*a, **kw),
            real, name))
    set_flags({"flash_short_seq": True})
    try:
        for dt, L in ((torch.float16, 128), (torch.bfloat16, 128),
                      (torch.float16, 64)):
            q = torch.randn(1, L, 2, 64).to(dt)
            out = F.scaled_dot_product_attention(q, q, q)
            assert out.dtype == dt
    finally:
        set_flags({"flash_short_seq": False})
    q = torch.randn(1, 128, 2, 64).half()
    assert F.scaled_dot_product_attention(q, q, q).dtype == torch.float16
    assert called == ["flash_attention_short", "flash_attention_short",
                      "flash_attention", "flash_attention"]
    assert counters.snapshot() == {}                  # the CPU runs plain


def test_f16_forms_not_ported_raise_and_f16_counts_apart():
    """Every form takes f16 now (this test's name is older than the
    short and external-lse f16 forms, which it held raising): their
    plain versions run on the CPU, write f16 and equal the streaming
    forms' plain arithmetic; f16 launches count under their own names,
    the three new ones among them."""
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.from_numpy(_f16(rng, 1, 128, 2, 64))
                   for _ in range(4))
    out, lse = tfa.flash_attention_short_fwd(q, k, v, True)
    sout, slse = tfa.flash_attention_fwd(q, k, v, True)
    assert out.dtype == torch.float16
    assert torch.equal(out, sout) and torch.equal(lse, slse)
    grads = tfa.flash_attention_short_bwd(q, k, v, out, lse, do, True)
    for got, want in zip(grads, tfa.flash_attention_bwd(q, k, v, out, lse,
                                                        do, True)):
        assert got.dtype == torch.float16 and torch.equal(got, want)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(2, 128).contiguous()
    ext = tfa.flash_attention_bwd_ext(q, k, v, do, lse, delta, True)
    for got, want in zip(ext, grads):
        assert got.dtype == torch.float16 and torch.equal(got, want)
    assert counters.snapshot() == {}                  # the CPU runs plain
    for name in ("flash_attention_fwd", "flash_attention_short_fwd",
                 "flash_attention_short_bwd", "flash_attention_ext_bwd"):
        assert tfa._counter(name, q) == name + "_f16"
        assert tfa._counter(name, q.bfloat16()) == name
        assert tfa._counter(name, q.float()) == name
    assert tfa._counter("flash_attention_masked_bwd", q.bfloat16()) == \
        "flash_attention_masked_bwd"


def _model_dq(q, k, v, out, lse, do, lift):
    """dq as the f16 kernel computes it (non-causal, no dropout): dS in
    f32, rounded to f16 as hi + lo, with each row lifted by 2^-E so that
    its largest |dS| 2^-E lies in [2^13, 2^14) (``lift``) or not (the bf16
    forms' arithmetic in f16), the products summed in f32, dq rounded to
    f16."""
    qm, km, vm, om, dom = (x.float().permute(0, 2, 1, 3)
                           for x in (q, k, v, out, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(qm @ km.transpose(-1, -2) * scale - lse.view(
        q.shape[0], q.shape[2], -1, 1))
    ds = p * (dom @ vm.transpose(-1, -2)
              - (dom * om).sum(-1, keepdim=True))
    e = torch.zeros_like(ds[..., :1])
    if lift:
        m = ds.abs().amax(-1, keepdim=True)
        e = torch.where(m > 0, torch.floor(torch.log2(m)) - 13, e)
    x = ds * torch.exp2(-e)
    hi = x.half().float()
    lo = (x - hi).half().float()
    dq = ((hi + lo) @ km) * torch.exp2(e) * scale
    return dq.half().permute(0, 2, 1, 3)


def test_the_2byte_check_holds_the_lifted_ds_and_rejects_the_unlifted():
    """At scale 1 (dO a unit gradient, no loss scaling) most of a row's
    dS lie below f16's normals: the f16 check's rule (one unit plus
    FLASH_TERMS_K f16 unit roundoffs of the terms' 2-norm, plus the f32
    sums' allowance) holds a model of the kernel's lifted dS rounding and
    rejects the same model without the lift, as the card's runs of the
    two builds did (``tools/flash_f16_lift.py``)."""
    rng = np.random.RandomState(3)
    B, L, H, D = 2, 128, 2, 64
    q, k, v = (torch.from_numpy(_f16(rng, B, L, H, D)) for _ in range(3))
    # the NMT's unit gradient: a mean over its 64 x 128 tokens
    do = torch.from_numpy(_f16(rng, B, L, H, D, mul=1.0 / (64 * L)))
    out, lse = tfa._plain_fwd(q.float(), k.float(), v.float(), False, 0.0, 0)
    out = out.half()
    want = tfa._plain_bwd(q.float(), k.float(), v.float(), out.float(), lse,
                          do.float(), False, 0.0, 0)[0]
    norms, sums = tfa._term_norms(q, k, v, out, lse, do, False, 0.0, 0)
    extra = (cs.FLASH_TERMS_K * cs.FLASH_UNIT_ROUNDOFF["float16"] * norms[1]
             + cs.FLASH_F32_SUMS * D * sums[0]
             + 1e-6 * float(want.abs().max()))
    lifted = cs.tolerance_ratio(torch, _model_dq(q, k, v, out, lse, do, True),
                                want, extra)
    unlifted = cs.tolerance_ratio(
        torch, _model_dq(q, k, v, out, lse, do, False), want, extra)
    assert lifted <= 1.0 < unlifted, (lifted, unlifted)
