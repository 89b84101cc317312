"""The port's optimizer slice against the JAX package on the CPU, from
the same numpy inputs: the SGD and Lamb kernels' plain versions
(``ops/cuda/fused_optimizer.py``) against the Pallas kernels in
interpret mode (``_run_grid`` with ``_sgd_kernel`` and with
``_lamb_phase1_kernel(dygraph=True)``), whole SGD and Lamb steps against
``apply_gradients_fn``, every learning-rate scheduler of
``optimizer.lr`` against the JAX one, and the gradient clips against
``apply_pytree``. On the CPU every wrapper runs its plain version; the
CUDA kernels are held against those on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import optimizer as jopt
from paddle_tpu.nn import clip as jclip
from paddle_tpu.ops.pallas import counters as jcounters
from paddle_tpu.ops.pallas import fused_optimizer as jfo
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.regularizer import L2Decay
from paddle_tpu_torch import nn
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.ops.cuda import fused_optimizer as tfo
from paddle_tpu_torch.optimizer import SGD, Lamb
from paddle_tpu_torch.optimizer import lr as tlr


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
    return torch.tensor(np.asarray(a))


def _close(got, want, rtol):
    """rtol, plus ``rtol`` of the tensor's largest value: XLA's CPU
    backend may fuse a product and a sum into one FMA where the port
    rounds each, a last-bit difference that shows as a large relative
    error where two terms cancel."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# K3-sgd
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_fused_sgd_matches_pallas_sgd_kernel(wd):
    """Three steps, the second skipped; p after each against the Pallas
    kernel fed the JAX optimizer's coupled L2 gradient ``g +
    L2Decay(wd).grad_term(p)`` (the port folds the term into the
    update), within rtol 1e-6 (XLA's CPU backend fuses ``p - lr*g``
    into one FMA; the port rounds the product, as the card's kernel
    does)."""
    n, lr = 3000, 0.01
    rng = np.random.RandomState(21)
    p = rng.randn(n).astype(np.float32)
    jp, tp = jnp.asarray(p), _t(p)
    for step in range(3):
        g = rng.randn(n).astype(np.float32) * 0.1
        skip = step == 1
        jg = jnp.asarray(g)
        if wd:
            jg = jg + L2Decay(wd).grad_term(jp)
        (jp,) = jfo._run_grid(jfo._sgd_kernel,
                              [jfo._scal(lr), jfo._scal(float(skip))],
                              [jp, jg], 1, n, True)
        before = tp.clone()
        tfo.fused_sgd_([tp], [_t(g)], lr=lr, weight_decay=wd, skip=skip)
        if skip:
            assert torch.equal(tp, before)
        else:
            assert not torch.equal(tp, before)
        _close(tp, jp, 1e-6)
    assert counters.snapshot() == {}                  # the CPU runs plain


def test_sgd_step_with_l2_and_clip_matches_the_jax_optimizer():
    """A whole SGD step with coupled L2 1e-4 and a global-norm clip that
    engages, against ``apply_gradients_fn`` (clip, then L2, then the
    kernel), rtol 1e-6."""
    rng = np.random.RandomState(22)
    ps = {"w": rng.randn(40, 64).astype(np.float32),
          "b": rng.randn(64).astype(np.float32)}
    gs = {k: rng.randn(*x.shape).astype(np.float32) for k, x in ps.items()}
    jo = jopt.SGD(learning_rate=0.1, parameters=[], weight_decay=1e-4,
                  grad_clip=jclip.ClipGradByGlobalNorm(1.0))
    state = jo.init_state({k: jnp.asarray(x) for k, x in ps.items()})
    jp, _ = jo.apply_gradients_fn({k: jnp.asarray(x) for k, x in gs.items()},
                                  {k: jnp.asarray(x) for k, x in ps.items()},
                                  state, 0.1)
    tps = {k: torch.nn.Parameter(_t(x)) for k, x in ps.items()}
    for k, t in tps.items():
        t.grad = _t(gs[k])
    SGD(learning_rate=0.1, parameters=list(tps.values()), weight_decay=1e-4,
        grad_clip=nn.ClipGradByGlobalNorm(1.0)).step()
    for k in ps:
        _close(tps[k].detach(), jp[k], 1e-6)


def test_fused_sgd_decay_is_rounded_as_the_optimizer_adds_it():
    """With a decay the plain version is, bit for bit, ``g + wd*p`` as
    the optimizer built it before the decay moved into the update
    (PyTorch's f32 product and sum), then ``p - lr*g``; with wd = 0 it
    is ``p - lr*g`` itself, even where ``g + 0*p`` is not ``g`` (an
    infinite p stays infinite, where 0*p would make it NaN)."""
    rng = np.random.RandomState(23)
    p = rng.randn(4099).astype(np.float32)
    g = rng.randn(4099).astype(np.float32) * 0.1
    p[:2] = np.inf, -np.inf
    lr = np.float32(0.01)
    for w in (1e-4, 0.0):
        tp = _t(p)
        tfo.fused_sgd_([tp], [_t(g)], lr=0.01, weight_decay=w)
        gw = _t(g) + w * _t(p) if w else _t(g)
        want = _t(p) - torch.tensor(lr) * gw
        assert torch.equal(tp.view(torch.int32), want.view(torch.int32))
    assert torch.equal(tp[:2], _t(p[:2]))


def test_sgd_passes_its_decay_to_the_kernel(monkeypatch):
    """``SGD`` hands the kernel the clipped gradients as they are and
    its float ``weight_decay`` (no ``g + wd*p`` tensors of its own);
    Momentum still adds the term to the gradients it passes."""
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.optimizer import optimizer as topt

    seen = {}

    def record(name):
        def fn(params, grads, *args, **kw):
            seen[name] = (list(grads), kw)
        return fn

    monkeypatch.setattr(topt, "fused_sgd_", record("sgd"))
    monkeypatch.setattr(topt, "fused_momentum_", record("momentum"))
    rng = np.random.RandomState(24)
    for cls, name in ((SGD, "sgd"), (Momentum, "momentum")):
        w = torch.nn.Parameter(_t(rng.randn(5, 3).astype(np.float32)))
        w.grad = _t(rng.randn(5, 3).astype(np.float32))
        cls(learning_rate=0.1, parameters=[w], weight_decay=1e-4).step()
        (g,), kw = seen[name]
        if name == "sgd":
            assert g is w.grad and kw["weight_decay"] == 1e-4
        else:
            assert torch.equal(g, w.grad + 1e-4 * w.detach())
            assert "weight_decay" not in kw


@pytest.mark.parametrize("n,cap,want", [
    (10, 1359, [(0, 10)]),
    (1359, 1359, [(0, 1359)]),
    (1400, 1359, [(0, 1359), (1359, 41)]),
    (2719, 1359, [(0, 1359), (1359, 1359), (2718, 1)]),
    (0, 1359, []),
    (206, 45, [(0, 45), (45, 45), (90, 45), (135, 45), (180, 26)]),
])
def test_table_splits_cut_a_long_list_in_order(n, cap, want):
    """A list whose table travels by value splits into consecutive
    launches of at most ``cap`` tensors that cover it once, in order."""
    got = tfo.table_splits(n, cap)
    assert got == want
    assert [i for a, k in got for i in range(a, a + k)] == list(range(n))


# ---------------------------------------------------------------------------
# K3-lamb
# ---------------------------------------------------------------------------
def _lamb_case(seed):
    """Several tensors, one of them all zeros (a bias at initialisation:
    its trust ratio is 1), with moments from earlier steps."""
    rng = np.random.RandomState(seed)
    shapes = [(40, 64), (64,), (3000,), (7, 5)]
    ps = [rng.randn(*s).astype(np.float32) * 0.05 for s in shapes]
    ps[1][:] = 0.0
    gs = [rng.randn(*s).astype(np.float32) * 0.01 for s in shapes]
    ms = [rng.randn(*s).astype(np.float32) * 0.001 for s in shapes]
    vs = [np.abs(rng.randn(*s)).astype(np.float32) * 1e-5 for s in shapes]
    return ps, gs, ms, vs


@pytest.mark.parametrize("step", [1, 5])
def test_fused_lamb_matches_pallas_lamb_kernel(step):
    """Phase 1 (m, v and the trust-ratio numerator r) against
    ``_run_grid(_lamb_phase1_kernel, dygraph=True)`` within rtol 1e-6,
    and the updated p against the JAX update that follows it in
    ``fused_try_rule`` (per-tensor norms, trust, ``p - (lr*trust)*r``)
    within rtol 1e-5."""
    b1, b2, eps, wd, lr = 0.9, 0.999, 1e-6, 0.01, 1e-3
    ps, gs, ms, vs = _lamb_case(step)
    tf = jnp.float32(step)
    c1 = (1 - b1 ** tf).astype(jnp.float32)
    c2 = (1 - b2 ** tf).astype(jnp.float32)
    kern = functools.partial(jfo._lamb_phase1_kernel, b1=b1, b2=b2, eps=eps,
                             wd=wd, dygraph=True)
    tp, tm, tv = ([_t(x) for x in xs] for xs in (ps, ms, vs))
    tr = [torch.empty_like(x) for x in tp]
    tfo.fused_lamb_(tp, [_t(g) for g in gs], tm, tv, tr, lr=lr, beta1=b1,
                    beta2=b2, eps=eps, weight_decay=wd, step=step)
    for i, (p, g, m, v) in enumerate(zip(ps, gs, ms, vs)):
        jm, jv, jr = jfo._run_grid(
            kern, [jfo._scal(c1), jfo._scal(c2)],
            [jnp.asarray(x) for x in (p, g, m, v)], 3, p.size, True)
        for got, want in ((tm[i], jm), (tv[i], jv), (tr[i], jr)):
            _close(got.reshape(-1), want, 1e-6)
        pf = jnp.asarray(p).reshape(-1)
        w_norm = jnp.sqrt(jnp.sum(jnp.square(pf)))
        r_norm = jnp.sqrt(jnp.sum(jnp.square(jr)))
        trust = jnp.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, 1.0)
        jp = pf - jnp.asarray(lr, jnp.float32) * trust * jr
        _close(tp[i].reshape(-1), jp, 1e-5)
    # the zero tensor moved by exactly lr * r (trust 1)
    np.testing.assert_array_equal(tp[1].numpy(),
                                  (-np.float32(lr) * tr[1]).numpy())
    assert counters.snapshot() == {}                  # the CPU runs plain


def test_fused_lamb_skip_leaves_state():
    ps, gs, ms, vs = _lamb_case(3)
    tp, tm, tv = ([_t(x) for x in xs] for xs in (ps, ms, vs))
    tfo.fused_lamb_(tp, [_t(g) for g in gs], tm, tv,
                    [torch.empty_like(x) for x in tp], lr=1e-3, beta1=0.9,
                    beta2=0.999, eps=1e-6, weight_decay=0.01, step=1,
                    skip=True)
    for got, want in zip(tp + tm + tv, ps + ms + vs):
        np.testing.assert_array_equal(got.numpy(), want)


def test_lamb_steps_match_the_jax_optimizer(monkeypatch):
    """Three Lamb steps with global-norm clipping over a mixed list (one
    tensor above the JAX kernel's 1024-element gate, a zero bias below
    it) against ``apply_gradients_fn`` with the Pallas kernel in
    interpret mode: p within rtol 1e-5, m and v within rtol 1e-6."""
    monkeypatch.setenv("PADDLE_FUSED_OPT_INTERPRET", "1")
    rng = np.random.RandomState(23)
    ps = {"w": rng.randn(40, 64).astype(np.float32) * 0.05,
          "b": np.zeros(64, np.float32)}
    jo = jopt.Lamb(learning_rate=1e-3, lamb_weight_decay=0.01, parameters=[],
                   grad_clip=jclip.ClipGradByGlobalNorm(1.0))
    jp = {k: jnp.asarray(x) for k, x in ps.items()}
    state = jo.init_state(jp)
    tps = {k: torch.nn.Parameter(_t(x)) for k, x in ps.items()}
    to = Lamb(learning_rate=1e-3, lamb_weight_decay=0.01,
              parameters=list(tps.values()),
              grad_clip=nn.ClipGradByGlobalNorm(1.0))
    before = jcounters.snapshot()
    for _ in range(3):
        gs = {k: rng.randn(*x.shape).astype(np.float32)
              for k, x in ps.items()}
        jp, state = jo.apply_gradients_fn(
            {k: jnp.asarray(x) for k, x in gs.items()}, jp, state, 1e-3)
        for k, t in tps.items():
            t.grad = _t(gs[k])
        to.step()
    assert jcounters.delta(before).get("fused_opt.pallas", 0) >= 1
    for k in ps:
        slots = to._slots[id(tps[k])]
        _close(tps[k].detach(), jp[k], 1e-5)
        _close(slots["moment1"], state["slots"][k]["moment1"], 1e-6)
        _close(slots["moment2"], state["slots"][k]["moment2"], 1e-6)


def test_lamb_keeps_the_jax_signature_and_ignores_the_exclude_fn():
    """``exclude_from_weight_decay_fn`` is stored and not applied, as in
    the JAX rule: excluding every parameter changes nothing."""
    p = torch.nn.Parameter(torch.ones(8))
    q = torch.nn.Parameter(torch.ones(8))
    for t in (p, q):
        t.grad = torch.full((8,), 0.5)
    Lamb(1e-2, parameters=[p]).step()
    Lamb(1e-2, parameters=[q], exclude_from_weight_decay_fn=lambda n: True
         ).step()
    assert torch.equal(p, q)


# ---------------------------------------------------------------------------
# optimizer.lr
# ---------------------------------------------------------------------------
_SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(512, 4000, learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([5, 12], [0.1, 0.01,
                                                          0.001]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, 0.1),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, 0.1),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, 20, end_lr=0.001,
                                                   power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(
        0.1, 7, end_lr=0.001, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, 5, 0.0, 0.1),
    "LinearWarmup_Polynomial": lambda m: m.LinearWarmup(
        m.PolynomialDecay(1e-3, decay_steps=1000, end_lr=0.0),
        warmup_steps=3, start_lr=0.0, end_lr=1e-3),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, 0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, [4, 9, 20]),
    "StepDecay": lambda m: m.StepDecay(0.5, 6, gamma=0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.5, 10,
                                                             eta_min=0.01),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, 30),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=4,
                                     mode="triangular2"),
    "CosineDecay": lambda m: m.CosineDecay(0.5, 3, 10),
    "noam_decay": lambda m: m.noam_decay(512, 10),
    "exponential_decay": lambda m: m.exponential_decay(0.5, 4, 0.9,
                                                       staircase=True),
    "natural_exp_decay": lambda m: m.natural_exp_decay(0.5, 4, 0.1),
    "inverse_time_decay": lambda m: m.inverse_time_decay(0.5, 4, 0.1),
    "piecewise_decay": lambda m: m.piecewise_decay([3, 8], [1.0, 0.5, 0.1]),
    "cosine_decay": lambda m: m.cosine_decay(0.5, 3, 10),
    "polynomial_decay": lambda m: m.polynomial_decay(0.5, 10),
    "linear_lr_warmup": lambda m: m.linear_lr_warmup(0.5, 4, 0.01, 0.5),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULERS))
def test_lr_scheduler_matches_jax(name):
    """30 steps of each scheduler: the same values, within 1e-12."""
    js, ts = _SCHEDULERS[name](jlr), _SCHEDULERS[name](tlr)
    got, want = [], []
    for _ in range(30):
        got.append(ts())
        want.append(js())
        ts.step()
        js.step()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_reduce_on_plateau_matches_jax():
    js = jlr.ReduceOnPlateau(0.1, factor=0.5, patience=2, cooldown=1)
    ts = tlr.ReduceOnPlateau(0.1, factor=0.5, patience=2, cooldown=1)
    metrics = [1.0, 0.9, 0.95, 0.97, 0.99, 0.9, 0.91, 0.92, 0.93, 0.94] * 3
    for i, m in enumerate(metrics):
        js.step(m)
        ts.step(torch.tensor(m) if i % 2 else m)
        assert ts() == js()


def test_optimizer_reads_the_scheduler_each_step():
    """``get_lr()`` is the scheduler's value; the user steps it; a
    learning rate of another type is refused."""
    sched = tlr.LinearWarmup(0.1, 4, 0.0, 0.1)
    opt = SGD(learning_rate=sched, parameters=[torch.nn.Parameter(
        torch.zeros(2))])
    seen = []
    for _ in range(5):
        seen.append(opt.get_lr())
        sched.step()
    np.testing.assert_allclose(seen, [0.0, 0.025, 0.05, 0.075, 0.1])
    with pytest.raises(TypeError):
        SGD(learning_rate="0.1", parameters=[])


# ---------------------------------------------------------------------------
# nn.clip
# ---------------------------------------------------------------------------
def _grads(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) * 3.0
            for s in ((30, 20), (20,), (5, 4, 3))] + [np.zeros(6, np.float32)]


@pytest.mark.parametrize("kind,args", [
    ("ClipGradByValue", (0.5,)), ("ClipGradByValue", (0.5, -0.2)),
    ("ClipGradByNorm", (1.0,)), ("ClipGradByNorm", (1e3,)),
    ("ClipGradByGlobalNorm", (1.0,)), ("ClipGradByGlobalNorm", (1e4,)),
], ids=["value", "value-asym", "norm", "norm-off", "global", "global-off"])
def test_clip_matches_jax_apply_pytree(kind, args):
    gs = _grads(31)
    want = getattr(jclip, kind)(*args).apply_pytree(
        [jnp.asarray(g) for g in gs])
    got = getattr(nn, kind)(*args).apply_pytree([_t(g) for g in gs])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=0)


def test_clip_pairs_aliases_and_clip_grad_norm():
    gs = _grads(32)
    ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    pairs = nn.GradientClipByGlobalNorm(1.0)([(p, _t(g))
                                              for p, g in zip(ps, gs)])
    assert [p for p, _ in pairs] == ps
    total = torch.stack([g.norm() for _, g in pairs]).norm()
    np.testing.assert_allclose(total.item(), 1.0, rtol=1e-6)
    assert nn.GradientClipByValue is nn.ClipGradByValue
    assert nn.GradientClipByNorm is nn.ClipGradByNorm
    for p, g in zip(ps, gs):
        p.grad = _t(g)
    gnorm = nn.clip_grad_norm_(ps, 2.0)
    want = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in gs))
    np.testing.assert_allclose(float(gnorm), want, rtol=1e-6)
    after = torch.stack([p.grad.norm() for p in ps]).norm()
    np.testing.assert_allclose(after.item(), 2.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# K3's master-weight forms (multi_precision)
# ---------------------------------------------------------------------------
def _spacing(x, dtype):
    """The gap between |x| and the next value of ``dtype`` above it."""
    t = torch.tensor(np.abs(np.asarray(x, np.float32))).to(dtype)
    return (torch.nextafter(t, torch.tensor(float("inf"), dtype=dtype))
            - t).float().numpy()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("rule", ["adamw", "momentum_l2", "sgd_wd", "lamb"])
def test_master_steps_match_the_jax_optimizer(monkeypatch, rule, dtype):
    """Three multi-precision steps over bf16/f16 parameters (one above
    the JAX kernel's 1024-element gate, so the Pallas kernel runs over
    its f32 master in interpret mode) against ``apply_gradients_fn``:
    the masters and f32 state within rtol 1e-6 (Lamb's norms: 1e-5),
    each parameter its master's cast bit for bit and within one unit of
    its type of JAX's parameter. Momentum's L2 and SGD's decay are added
    in the parameter's type before the upcast, as JAX adds them."""
    monkeypatch.setenv("PADDLE_FUSED_OPT_INTERPRET", "1")
    from paddle_tpu_torch import regularizer as treg
    from paddle_tpu_torch.optimizer import AdamW, Momentum

    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.RandomState(31)
    ps = {"w": rng.randn(40, 64).astype(np.float32) * 0.05,
          "b": rng.randn(64).astype(np.float32) * 0.05}
    make = {
        "adamw": (lambda: jopt.AdamW(learning_rate=1e-3, weight_decay=0.01,
                                     parameters=[], multi_precision=True),
                  lambda p: AdamW(learning_rate=1e-3, weight_decay=0.01,
                                  parameters=p, multi_precision=True)),
        "momentum_l2": (lambda: jopt.Momentum(
            learning_rate=0.1, momentum=0.9, parameters=[],
            weight_decay=L2Decay(1e-4), multi_precision=True),
            lambda p: Momentum(learning_rate=0.1, momentum=0.9,
                               parameters=p,
                               weight_decay=treg.L2Decay(1e-4),
                               multi_precision=True)),
        "sgd_wd": (lambda: jopt.SGD(learning_rate=0.1, weight_decay=1e-4,
                                    parameters=[], multi_precision=True),
                   lambda p: SGD(learning_rate=0.1, weight_decay=1e-4,
                                 parameters=p, multi_precision=True)),
        "lamb": (lambda: jopt.Lamb(learning_rate=1e-3, parameters=[],
                                   multi_precision=True),
                 lambda p: Lamb(learning_rate=1e-3, parameters=p,
                                multi_precision=True))}[rule]
    jo = make[0]()
    jp = {k: jnp.asarray(x).astype(jdt) for k, x in ps.items()}
    state = jo.init_state(jp)
    tps = {k: torch.nn.Parameter(_t(x).to(tdt)) for k, x in ps.items()}
    to = make[1](list(tps.values()))
    before = jcounters.snapshot()
    lr = jo.get_lr()
    for _ in range(3):
        gs = {k: (rng.randn(*x.shape) * 0.1).astype(np.float32)
              for k, x in ps.items()}
        jp, state = jo.apply_gradients_fn(
            {k: jnp.asarray(g).astype(jdt) for k, g in gs.items()}, jp,
            state, lr)
        for k, t in tps.items():
            t.grad = _t(gs[k]).to(tdt)
        to.step()
    assert jcounters.delta(before).get("fused_opt.pallas", 0) >= 1
    rtol = 1e-5 if rule == "lamb" else 1e-6
    for k in ps:
        slots = to._slots[id(tps[k])]
        jslots = state["slots"][k]
        assert set(slots) == set(jslots)
        for name, got in slots.items():
            assert got.dtype == torch.float32
            _close(got, jslots[name], rtol)
        p = tps[k].detach()
        assert p.dtype == tdt
        assert torch.equal(p, slots["__master__"].to(tdt))
        want = np.asarray(jp[k]).astype(np.float32)
        assert np.all(np.abs(p.float().numpy() - want)
                      <= _spacing(want, tdt)), k


def test_sgd_master_decay_is_rounded_in_the_parameter_type():
    """The master form's ``g + wd*p`` is the 2-byte computation (wd
    rounded to the type, the product and the sum each rounded), not the
    f32 one: a case where the two differ."""
    p = torch.tensor([1.0, 3.0, -7.0], dtype=torch.bfloat16)
    g = torch.tensor([1e-3, 2.5e-4, 1e-2], dtype=torch.bfloat16)
    master = p.float()
    wd = 0.013
    tfo.fused_sgd_([p], [g], lr=0.5, weight_decay=wd, masters=[master])
    wd16 = torch.tensor(wd, dtype=torch.bfloat16)
    g2 = (g + wd16 * torch.tensor([1.0, 3.0, -7.0], dtype=torch.bfloat16))
    want = torch.tensor([1.0, 3.0, -7.0]) - torch.tensor(0.5) * g2.float()
    assert torch.equal(master, want)
    f32_way = torch.tensor([1.0, 3.0, -7.0]) - 0.5 * (
        g.float() + np.float32(wd) * torch.tensor([1.0, 3.0, -7.0]))
    assert not torch.equal(master, f32_way)
    assert torch.equal(p, master.to(torch.bfloat16))
