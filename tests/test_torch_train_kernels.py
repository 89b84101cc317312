"""The training slice's kernel modules (paddle_tpu_torch/ops/cuda:
flash_attention, fused_xent, fused_optimizer) held against the JAX
package's Pallas kernels in interpret mode on the CPU, from the same
numpy inputs. On the CPU every wrapper runs its plain version; the CUDA
kernels are held against those plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

- K1 flash attention: out and lse against ``_flash_attention_core_fwd``
  and dq/dk/dv through autograd against ``jax.vjp`` of
  ``_flash_attention_pallas``, causal and not; f32, atol 1e-5 (the
  sums run in another order).
- K2 fused xent: loss, dh, dW, db against ``_fused_xent_core`` and its
  vjp, with ignored rows and N = 300 (the JAX side pads to 512 with
  ignored rows, as its wrapper does); atol 1e-5. The 2-byte forms over
  bf16 and f16 inputs: the loss within 1e-5, the gradients in the
  inputs' type within one unit of it element by element; the card
  checks' tolerance for the kernels' rounding of P' (one unit plus four
  unit roundoffs of ``_term_norms``) against a model of that rounding,
  and against a softmax part 3 % off, which it rejects.
- K3 Adam: p, m, v against ``_run_grid(_adam_kernel, dygraph=True)``
  and the decoupled AdamW decay, rtol 1e-6; and a whole AdamW step
  against the JAX optimizer with ``PADDLE_FUSED_OPT_INTERPRET=1``.
- K3 Momentum: p and v over several steps against
  ``_run_grid(_momentum_kernel)``, with and without Nesterov, the skip
  flag included; and a whole Momentum step against the JAX optimizer
  with ``PADDLE_FUSED_OPT_INTERPRET=1``.
- The plain Philox dropout: its keep rate, its dependence on the seed,
  and a float64 gradient check of the plain K1 with dropout on (the
  backward regenerates the forward's mask).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas import fused_optimizer as jfo
from paddle_tpu.ops.pallas import fused_xent as jfx
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import fused_optimizer as tfo
from paddle_tpu_torch.ops.cuda import fused_xent as tfx

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
    counters.reset()


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


# ---------------------------------------------------------------------------
# K1: flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_forward_matches_pallas(causal):
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(1, 256, 2, 64).astype(np.float32) for _ in range(3))
    jout, res = jfa._flash_attention_core_fwd(jnp.asarray(q), jnp.asarray(k),
                                              jnp.asarray(v), causal, 128,
                                              128)
    jlse = np.asarray(res[4])[:, 0, :]                # (B*H, L)
    out, lse = tfa.flash_attention_fwd(_t(q), _t(k), _t(v), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=ATOL, rtol=0)
    assert counters.snapshot() == {}                  # the CPU runs plain


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_backward_matches_pallas_vjp(causal):
    rng = np.random.RandomState(2)
    q, k, v, do = (rng.randn(1, 256, 2, 64).astype(np.float32)
                   for _ in range(4))
    _, vjp = jax.vjp(lambda a, b, c: jfa._flash_attention_pallas(
        a, b, c, causal=causal), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(do))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    tfa.flash_attention(tq, tk, tv, causal=causal).backward(_t(do))
    for got, want in ((tq.grad, jdq), (tk.grad, jdk), (tv.grad, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)


def test_philox_keep_rate_and_seed_dependence():
    p = 0.1
    mask = tfa.philox_keep_mask(1234, 16, 250, 250, p)   # 10**6 draws
    assert mask.shape == (16, 250, 250)
    assert abs(mask.double().mean().item() - (1 - p)) < 0.01
    assert torch.equal(mask, tfa.philox_keep_mask(1234, 16, 250, 250, p))
    other = tfa.philox_keep_mask(1235, 16, 250, 250, p)
    assert (mask != other).double().mean().item() > 0.1
    # a function of element coordinates: a sub-block is the same bits
    sub = tfa.philox_keep_mask(1234, 3, 70, 130, p)
    assert torch.equal(sub, mask[:3, :70, :130])


def test_philox_matches_the_reference_vector():
    """Philox4x32-10 with counter 0 and key 0 gives Random123's known
    answer (6627e8d5 e169c58d bc57ac4c 9b00dbd8)."""
    z = torch.zeros(1, dtype=torch.int64)
    words = tfa._philox4x32_10(z, z, z, z, 0)
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                       0x9B00DBD8]


def test_flash_dropout_plain_gradcheck_float64():
    """The plain K1 with dropout 0.3, in float64: autograd's analytic
    backward (which regenerates the mask from the seed) equals the
    finite-difference gradient of the forward."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.tensor(rng.randn(1, 20, 2, 8), dtype=torch.float64,
                            requires_grad=True) for _ in range(3))

    def f(a, b, c):
        return tfa.flash_attention(a, b, c, causal=False, dropout_p=0.3,
                                   seed=99)

    assert torch.autograd.gradcheck(f, (q, k, v), eps=1e-6, atol=1e-6)
    out = f(q, k, v)
    assert not torch.equal(out, tfa.flash_attention(q, k, v))   # dropped


def test_flash_dropout_mask_reaches_the_output():
    """With q = k = 0 every probability is 1/L; with v the identity the
    output is keep / (L * (1 - p)), so the mask reads back exactly."""
    L, p = 64, 0.25
    q = torch.zeros(1, L, 1, 64)
    v = torch.eye(L).reshape(1, L, 1, 64)
    out = tfa.flash_attention(q, q, v, dropout_p=p, seed=7)
    keep = tfa.philox_keep_mask(7, 1, L, L, p)[0]
    assert torch.equal(out[0, :, 0, :] > 0, keep)
    np.testing.assert_allclose(out[0, :, 0, :][keep].numpy(),
                               1.0 / (L * (1 - p)), rtol=1e-6)


# ---------------------------------------------------------------------------
# K2: fused linear + vocabulary cross-entropy
# ---------------------------------------------------------------------------
def _xent_case(n=300, h=128, v=1024, seed=0):
    rng = np.random.RandomState(seed)
    hm = (rng.randn(n, h) * 0.2).astype(np.float32)
    w = (rng.randn(v, h) * 0.2).astype(np.float32)
    b = (rng.randn(v) * 0.1).astype(np.float32)
    lab = rng.randint(0, v, n).astype(np.int32)
    lab[rng.rand(n) < 0.3] = -100
    return hm, w, b, lab


def test_fused_xent_loss_and_grads_match_pallas():
    hm, w, b, lab = _xent_case()
    n, pad = hm.shape[0], (-hm.shape[0]) % 256
    hp = np.concatenate([hm, np.zeros((pad, hm.shape[1]), np.float32)])
    lp = np.concatenate([lab, np.full(pad, -100, np.int32)])
    jloss, vjp = jax.vjp(
        lambda a, c, d: jfx._fused_xent_core(a, c, d, jnp.asarray(lp), -100),
        jnp.asarray(hp), jnp.asarray(w), jnp.asarray(b))
    jdh, jdw, jdb = vjp(jnp.ones((), jnp.float32))
    th, tw, tb = _t(hm, True), _t(w, True), _t(b, True)
    loss = tfx.fused_linear_cross_entropy(th, tw, tb, _t(lab))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL,
                               rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh)[:n],
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jdb), atol=ATOL,
                               rtol=0)


def _spacing(x, dtype):
    """The gap between |x| and the next value of ``dtype`` above it."""
    t = torch.tensor(np.abs(np.asarray(x, np.float32))).to(dtype)
    return (torch.nextafter(t, torch.tensor(float("inf"), dtype=dtype))
            - t).float().numpy()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_fused_xent_2byte_plain_matches_pallas(dtype):
    """K2 over bf16/f16 h, W and bias (what O2 hands the MLM head): the
    port's plain version upcasts to f32 and rounds dh, dW, db to the
    inputs' type, as the Pallas kernels do (``fused_xent.py:98-167``,
    ``:256``, ``:302``). The loss (f32) within 1e-5; each gradient in
    the inputs' type, element by element within one unit of that type
    of the Pallas kernel's, plus 1e-6 of the largest value (the two f32
    sums round to neighbours)."""
    hm, w, b, lab = _xent_case()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    n, pad = hm.shape[0], (-hm.shape[0]) % 256
    hp = np.concatenate([hm, np.zeros((pad, hm.shape[1]), np.float32)])
    lp = np.concatenate([lab, np.full(pad, -100, np.int32)])
    jloss, vjp = jax.vjp(
        lambda a, c, d: jfx._fused_xent_core(a, c, d, jnp.asarray(lp), -100),
        *(jnp.asarray(x).astype(jdt) for x in (hp, w, b)))
    jgrads = vjp(jnp.ones((), jnp.float32))
    ts = [_t(x).to(tdt).requires_grad_() for x in (hm, w, b)]
    loss = tfx.fused_linear_cross_entropy(*ts, _t(lab))
    assert loss.dtype == torch.float32
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL,
                               rtol=1e-6)
    for t, jg, rows in zip(ts, jgrads, (n, None, None)):
        assert t.grad.dtype == tdt and str(jg.dtype) == dtype
        want = np.asarray(jg.astype(jnp.float32))[:rows]
        got = t.grad.float().numpy()
        unit = _spacing(np.maximum(np.abs(got), np.abs(want)), tdt)
        assert np.all(np.abs(got - want)
                      <= unit + 1e-6 * np.abs(want).max()), t.shape
    assert counters.snapshot() == {}                  # the CPU runs plain


def _rounded_p_grads(h, w, b, lab, lse, g, tdt, factor=1.0):
    """dh and dW (f32 sums) with P' = (P - onehot) g rounded to ``tdt``
    as the card's 2-byte kernels round it: dh's P - onehot lifted by
    2^14, dW's P' by 2^(14 - e), 2^e the largest |g| of the launch
    rounded down to a power of two (one lift for every row, so dW's
    accumulator takes each step's product unscaled). ``factor`` scales
    P (not the onehot): a wrong softmax part."""
    p = torch.exp(h @ w.t() + b - lse[:, None]) * factor
    hit = lab >= 0
    p[hit.nonzero()[:, 0], lab[hit].long()] -= 1.0
    dh = ((p * 2.0 ** 14).to(tdt).float() @ w) * (g / 2.0 ** 14)[:, None]
    gm = float(g.abs().max())
    sc = 2.0 ** (14 - (math.frexp(gm)[1] - 1 if gm > 0 else 0))
    dw = ((p * g[:, None] * sc).to(tdt).float() / sc).t() @ h
    return dh, dw


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_fused_xent_2byte_check_tolerance_holds_the_p_rounding(dtype):
    """The card checks of K2's 2-byte forms hold dh and dW element by
    element against the plain version's f32 values within one unit of
    the type plus four unit roundoffs u times ``_term_norms`` (the
    2-norm of the element's terms). ``_term_norms`` equals the norms
    taken in f64 (and db's 1-norms); the kernels' rounding of P' (modelled here, per-row
    gradients over several binades, f16 at a loss scale of 2^10) stays
    within that tolerance; a softmax part 3 % off does not, in dh or in
    dW."""
    hm, w, b, lab = _xent_case(n=300, h=64, v=3000)
    tdt = getattr(torch, dtype)
    rng = np.random.RandomState(1)
    scale = 1024.0 if dtype == "float16" else 1.0
    g = _t(((lab >= 0) * rng.uniform(0.1, 4.0, lab.shape) * scale
            / 300).astype(np.float32))
    ts = [_t(x).to(tdt) for x in (hm, w, b)]
    up = [t.float() for t in ts]
    tl = _t(lab)
    lse, _ = tfx._plain_fwd(*ts, tl)
    f32 = tfx._plain_bwd(*up, tl, lse, g)[:2]
    *norms, l1 = tfx._term_norms(*ts, tl, lse, g)
    pg = (torch.exp(up[0] @ up[1].t() + up[2] - lse[:, None]).double()
          * g[:, None].double())
    pg[(lab >= 0).nonzero()[0], lab[lab >= 0]] -= g.double()[lab >= 0]
    want = ((pg ** 2) @ up[1].double() ** 2, (pg.t() ** 2)
            @ up[0].double() ** 2)
    for n, m in zip(norms, want):
        np.testing.assert_allclose(n.numpy(), np.sqrt(m.numpy()),
                                   rtol=1e-5, atol=0)
    np.testing.assert_allclose(l1.numpy(), pg.abs().sum(0).numpy(),
                               rtol=1e-5, atol=0)
    u = 2.0 ** (-8 if dtype == "bfloat16" else -11)

    def ratio(got, ref, n):
        got = got.to(tdt)
        big = torch.maximum(got.abs(), ref.abs().to(tdt))
        unit = (torch.nextafter(big, torch.tensor(float("inf"), dtype=tdt))
                - big).float()
        extra = 4 * u * n + 1e-6 * float(ref.abs().max())
        return float(((got.float() - ref).abs() / (unit + extra)).max())

    ok = _rounded_p_grads(*up, tl, lse, g, tdt)
    wrong = _rounded_p_grads(*up, tl, lse, g, tdt, factor=1.03)
    assert max(ratio(x, y, n) for x, y, n in zip(ok, f32, norms)) <= 1.0
    assert min(ratio(x, y, n) for x, y, n in zip(wrong, f32, norms)) > 1.0
    assert counters.snapshot() == {}


def test_fused_xent_all_rows_ignored_is_zero():
    hm, w, b, lab = _xent_case(n=40)
    lab[:] = -100
    th = _t(hm, True)
    loss = tfx.fused_linear_cross_entropy(th, _t(w), _t(b), _t(lab))
    loss.backward()
    assert loss.item() == 0.0 and not th.grad.abs().sum().item()


# ---------------------------------------------------------------------------
# K3: fused Adam
# ---------------------------------------------------------------------------
def _adam_case(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(n).astype(np.float32) * s
            for s in (1.0, 0.1, 0.01, 0.001)]


@pytest.mark.parametrize("step", [1, 7])
def test_fused_adam_matches_pallas_adam_kernel(step):
    n, lr, b1, b2, eps, wd = 3000, 1e-3, 0.9, 0.999, 1e-8, 0.01
    p, g, m, v = _adam_case(n, step)
    v = np.abs(v)
    tf = jnp.float32(step)
    c1 = (1 - b1 ** tf).astype(jnp.float32)
    c2 = (1 - b2 ** tf).astype(jnp.float32)
    kern = functools.partial(jfo._adam_kernel, b1=b1, b2=b2, eps=eps,
                             dygraph=True)
    jp, jm, jv = jfo._run_grid(
        kern, [jfo._scal(lr), jfo._scal(c1), jfo._scal(c2), jfo._scal(0.0)],
        [jnp.asarray(x) for x in (p, g, m, v)], 3, n, True)
    # AdamW's decoupled decay with the OLD p (optimizer.py:133-134)
    jp = jp - jnp.asarray(lr, jnp.float32) * wd * jnp.asarray(p)
    tp, tm, tv = _t(p), _t(m), _t(v)
    tfo.fused_adam_([tp], [_t(g)], [tm], [tv], lr=lr, beta1=b1, beta2=b2,
                    eps=eps, step=step, weight_decay=wd)
    # rtol 1e-6, plus 1e-6 of the tensor's largest value: XLA's CPU
    # backend may fuse b1*m + (1-b1)*g into one FMA where the port
    # rounds each product, a last-bit difference of a term that shows
    # as a large relative error where the two terms cancel
    for got, want in ((tp, jp), (tm, jm), (tv, jv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def test_fused_adam_skip_leaves_state():
    p, g, m, v = (_t(x) for x in _adam_case(50, 0))
    before = [x.clone() for x in (p, m, v)]
    tfo.fused_adam_([p], [g], [m], [v.abs()], lr=1e-3, beta1=0.9,
                    beta2=0.999, eps=1e-8, step=1, skip=True)
    for x, y in zip((p, m), before[:2]):
        assert torch.equal(x, y)


def test_adamw_step_matches_the_jax_optimizer(monkeypatch):
    """A whole AdamW step over a mixed list (one param above the JAX
    kernel's 1024-element gate, one below it) against
    ``apply_gradients_fn`` with the Pallas kernel in interpret mode."""
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.ops.pallas import counters as jcounters
    from paddle_tpu_torch.optimizer import AdamW

    monkeypatch.setenv("PADDLE_FUSED_OPT_INTERPRET", "1")
    rng = np.random.RandomState(5)
    ps = {"w": rng.randn(40, 64).astype(np.float32),
          "b": rng.randn(64).astype(np.float32)}
    gs = {k: rng.randn(*x.shape).astype(np.float32) * 0.1
          for k, x in ps.items()}
    jo = jopt.AdamW(learning_rate=1e-3, weight_decay=0.01, parameters=[])
    state = jo.init_state({k: jnp.asarray(x) for k, x in ps.items()})
    before = jcounters.snapshot()
    jp, state = jo.apply_gradients_fn({k: jnp.asarray(x)
                                       for k, x in gs.items()},
                                      {k: jnp.asarray(x)
                                       for k, x in ps.items()}, state, 1e-3)
    assert jcounters.delta(before).get("fused_opt.pallas", 0) >= 1
    tps = {k: torch.nn.Parameter(_t(x)) for k, x in ps.items()}
    for k, t in tps.items():
        t.grad = _t(gs[k])
    to = AdamW(learning_rate=1e-3, weight_decay=0.01,
               parameters=list(tps.values()))
    to.step()
    for k in ps:
        slots = to._slots[id(tps[k])]
        for got, want in ((tps[k].detach(), jp[k]),
                          (slots["moment1"], state["slots"][k]["moment1"]),
                          (slots["moment2"], state["slots"][k]["moment2"])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# K3: fused Momentum
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nesterov", [False, True], ids=["plain", "nesterov"])
def test_fused_momentum_matches_pallas_momentum_kernel(nesterov):
    """Four steps, the third one skipped (the FoundInfinite flag), from
    a non-zero velocity; p and v after each step against the Pallas
    kernel. rtol 1e-6 with a floor of 1e-6 of the largest value: XLA's
    CPU backend may fuse ``mu*v + g`` into one FMA where the port rounds
    the product."""
    n, lr, mu = 3000, 0.1, 0.9
    rng = np.random.RandomState(11)
    p = rng.randn(n).astype(np.float32)
    v = rng.randn(n).astype(np.float32) * 0.01
    kern = functools.partial(jfo._momentum_kernel, mu=mu, nesterov=nesterov)
    jp, jv = jnp.asarray(p), jnp.asarray(v)
    tp, tv = _t(p), _t(v)
    for step in range(4):
        g = rng.randn(n).astype(np.float32) * 0.1
        skip = step == 2
        jp, jv = jfo._run_grid(kern, [jfo._scal(lr), jfo._scal(float(skip))],
                               [jp, jnp.asarray(g), jv], 2, n, True)
        before = (tp.clone(), tv.clone())
        tfo.fused_momentum_([tp], [_t(g)], [tv], lr=lr, momentum=mu,
                            nesterov=nesterov, skip=skip)
        if skip:
            assert torch.equal(tp, before[0]) and torch.equal(tv, before[1])
        for got, want in ((tp, jp), (tv, jv)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
    assert counters.snapshot() == {}                  # the CPU runs plain


def test_fused_momentum_first_step_is_exact():
    """From a zero velocity, v after one step is g itself and p is
    ``p - lr*g`` rounded once, bit for bit."""
    rng = np.random.RandomState(12)
    p, g = (rng.randn(500).astype(np.float32) for _ in range(2))
    tp, tv = _t(p), torch.zeros(500)
    tfo.fused_momentum_([tp], [_t(g)], [tv], lr=0.1, momentum=0.9,
                        nesterov=False)
    assert torch.equal(tv, _t(g))
    assert np.array_equal(tp.numpy(), p - np.float32(0.1) * g)


def test_momentum_step_matches_the_jax_optimizer(monkeypatch):
    """A whole Momentum step over a mixed list (one param above the JAX
    kernel's 1024-element gate, one below it) against
    ``apply_gradients_fn`` with the Pallas kernel in interpret mode."""
    from paddle_tpu import optimizer as jopt
    from paddle_tpu.ops.pallas import counters as jcounters
    from paddle_tpu_torch.optimizer import Momentum

    monkeypatch.setenv("PADDLE_FUSED_OPT_INTERPRET", "1")
    rng = np.random.RandomState(13)
    ps = {"w": rng.randn(64, 3, 3, 3).astype(np.float32),
          "b": rng.randn(64).astype(np.float32)}
    gs = {k: rng.randn(*x.shape).astype(np.float32) * 0.1
          for k, x in ps.items()}
    jo = jopt.Momentum(learning_rate=0.1, momentum=0.9, parameters=[])
    state = jo.init_state({k: jnp.asarray(x) for k, x in ps.items()})
    before = jcounters.snapshot()
    jp, state = jo.apply_gradients_fn({k: jnp.asarray(x)
                                       for k, x in gs.items()},
                                      {k: jnp.asarray(x)
                                       for k, x in ps.items()}, state, 0.1)
    assert jcounters.delta(before).get("fused_opt.pallas", 0) >= 1
    tps = {k: torch.nn.Parameter(_t(x)) for k, x in ps.items()}
    for k, t in tps.items():
        t.grad = _t(gs[k])
    to = Momentum(learning_rate=0.1, momentum=0.9,
                  parameters=list(tps.values()))
    to.step()
    for k in ps:
        for got, want in ((tps[k].detach(), jp[k]),
                          (to._slots[id(tps[k])]["velocity"],
                           state["slots"][k]["velocity"])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
