"""The rounding of the tensor-core fused linear + cross-entropy kernels
(K2a's forward and K2b's backward, ``csrc/fused_xent.cu``) modelled on
the CPU and held against the JAX kernels in interpret mode, so that the
numerical design is checked before it reaches the card.

The model (test-local, in f32 torch arithmetic) rounds where the kernels
do:

- h and W split once into bf16 terms: hi, the rounding of x, and lo, the
  rounding of x - hi;
- every product as three bf16 terms, hi hi + hi lo + lo hi, added to an
  f32 accumulator 16 deep at a time along the reduction axis (the mma's
  depth) in the kernels' order; dh and dW form each 64-deep step in its
  own accumulator and add it to the running sum;
- the logits S = h W^T formed per 256-column slice of H (one CTA of the
  cluster each), the slices' partials added in rank order, then the bias
  in f32;
- forward: an online (max, sum of exponentials) over 64-column vocab
  tiles, kept for each class of eight columns one thread holds (column
  32 wc + 8 i + 2 t + e of a tile: warp half wc, quad thread t), then
  merged in the kernels' fixed order: the quad's threads by xor 1, then
  xor 2, then the two warps;
- backward: P' = (exp(S + b - lse) - onehot) g in f32, entering
  dh = P' W and dW = P'^T h as hi + lo; db sums P' in f32 over 64-row
  tiles.

References: ``_fwd_call`` and ``_bwd_call`` (the TPU kernels K2a and
K2b) and ``_fused_xent_core`` with ``pl.pallas_call`` in interpret mode,
and the port's plain versions. Tolerance: the card check's, 1e-4 of each
output's largest value. Shapes: N 300, H 128 and 768, V 1000, 15 % of
rows ignored, and a case with every row ignored. The last test shows that
one bf16 term a product misses that tolerance at H 768.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused_xent as jfx
from paddle_tpu_torch.ops.cuda import fused_xent as tfx

TOL = 1e-4
SLICE, TILE, DEPTH = 256, 64, 16


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    """Run pallas_call in interpret mode so the JAX kernels run on CPU."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(real, interpret=True))


def bf(x):
    return x.to(torch.bfloat16).float()


def split(x):
    """(hi, lo): x's bf16 rounding and the rounding of what is left."""
    hi = bf(x)
    return hi, bf(x - hi)


def mm(a, b, terms=3, step=None):
    """a (M, K) @ b (K, N) as the kernels form it: f32 accumulation 16
    deep at a time of hi hi + hi lo + lo hi (``terms`` 1: hi hi); with
    ``step``, each ``step``-deep part in its own accumulator, added to the
    running sum."""
    if step is not None:
        acc = None
        for k0 in range(0, a.shape[1], step):
            k = slice(k0, k0 + step)
            part = mm(a[:, k], b[k], terms)
            acc = part if acc is None else acc + part
        return acc
    (ah, al), (bh, bl) = split(a), split(b)
    acc = torch.zeros((a.shape[0], b.shape[1]))
    for k0 in range(0, a.shape[1], DEPTH):
        k = slice(k0, k0 + DEPTH)
        acc = acc + ah[:, k] @ bh[k]
        if terms == 3:
            acc = acc + ah[:, k] @ bl[k]
            acc = acc + al[:, k] @ bh[k]
    return acc


def logits(h, w, b, terms=3):
    """S + b: one partial a 256-column slice of H, added in rank order."""
    s = None
    for k0 in range(0, h.shape[1], SLICE):
        k = slice(k0, k0 + SLICE)
        part = mm(h[:, k], w[:, k].t(), terms)
        s = part if s is None else s + part
    return s + b


def lse_merge(ma, la, mb, lb):
    mn = torch.maximum(ma, mb)
    return mn, la * torch.exp(ma - mn) + lb * torch.exp(mb - mn)


def label_logit(s, labels):
    V = s.shape[1]
    hit = (labels >= 0) & (labels < V)
    picked = s.gather(1, labels.long().clamp(0, V - 1)[:, None])[:, 0]
    return torch.where(hit, picked, torch.zeros_like(picked))


def model_fwd(h, w, b, labels, terms=3):
    """K2a: (lse, label logit)."""
    N, V = h.shape[0], w.shape[0]
    s = logits(h, w, b, terms)
    m = torch.full((N, 2, 4), -1e30)          # (row, warp half, thread)
    l = torch.zeros((N, 2, 4))
    for v0 in range(0, V, TILE):
        x = torch.full((N, TILE), float("-inf"))
        x[:, :min(TILE, V - v0)] = s[:, v0:v0 + TILE]
        # column 32 wc + 8 i + 2 t + e -> (wc, t), eight values (i, e)
        x = x.view(N, 2, 4, 4, 2).permute(0, 1, 3, 2, 4).reshape(N, 2, 4, 8)
        mn = torch.maximum(m, x.amax(-1))
        l = l * torch.exp(m - mn) + torch.exp(x - mn[..., None]).sum(-1)
        m = mn
    m01, l01 = lse_merge(m[..., 0], l[..., 0], m[..., 1], l[..., 1])
    m23, l23 = lse_merge(m[..., 2], l[..., 2], m[..., 3], l[..., 3])
    mq, lq = lse_merge(m01, l01, m23, l23)
    M, L = lse_merge(mq[:, 0], lq[:, 0], mq[:, 1], lq[:, 1])
    return M + torch.log(torch.clamp(L, min=1e-30)), label_logit(s, labels)


def model_bwd(h, w, b, labels, lse, g, terms=3):
    """K2b: (dh, dW, db) of sum_n g[n] (lse[n] - ll[n])."""
    N, V = h.shape[0], w.shape[0]
    p = torch.exp(logits(h, w, b, terms) - lse[:, None])
    hit = (labels >= 0) & (labels < V)
    p = p.scatter_add(1, labels.long().clamp(0, V - 1)[:, None],
                      -hit.float()[:, None]) * g[:, None]
    db = torch.zeros(V)
    for n0 in range(0, N, TILE):
        db = db + p[n0:n0 + TILE].sum(0)
    return mm(p, w, terms, TILE), mm(p.t(), h, terms, TILE), db


def _case(N, H, V, ignored, seed):
    """h ~ N(0, 1), W and b ~ 0.02 N(0, 1) (BERT's initialiser scale),
    labels -1 on the ignored rows, g = d(mean) / d(row loss)."""
    rng = np.random.RandomState(seed)
    h = rng.randn(N, H).astype(np.float32)
    w = (rng.randn(V, H) * 0.02).astype(np.float32)
    b = (rng.randn(V) * 0.02).astype(np.float32)
    lab = rng.randint(0, V, N).astype(np.int32)
    lab[rng.rand(N) < ignored] = -1
    g = ((lab >= 0) / max(int((lab >= 0).sum()), 1)).astype(np.float32)
    return h, w, b, lab, g


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= TOL * scale, f"{name}: max abs err {err} against {scale}"


def _jax_kernels(h, w, b, lab, g, bn=100, bv=200):
    """``_fwd_call`` and ``_bwd_call`` in interpret mode, the backward from
    the JAX forward's lse: (lse, ll, dh, dW, db)."""
    jh, jw, jb, jl, jg = (jnp.asarray(x) for x in (h, w, b, lab, g))
    lse, ll = jfx._fwd_call(jh, jw, jb, jl, bn, bv)
    dh, dw, db = jfx._bwd_call(jh, jw, jb, jl, lse, jg, bn, bv)
    return [np.asarray(x) for x in (lse, ll, dh, dw, db)]


@pytest.mark.parametrize("H,ignored", [(128, 0.15), (768, 0.15),
                                       (768, 1.0)],
                         ids=["H128", "H768", "H768-all-ignored"])
def test_three_term_model_meets_the_card_tolerance(H, ignored):
    """The model against the TPU kernels in interpret mode and the plain
    version: lse, label logit, dh, dW, db within 1e-4 of the largest."""
    h, w, b, lab, g = _case(300, H, 1000, ignored, seed=H)
    th, tw, tb, tl, tg = (torch.tensor(x) for x in (h, w, b, lab, g))
    lse, ll = model_fwd(th, tw, tb, tl)
    got = (lse, ll) + model_bwd(th, tw, tb, tl, lse, tg)
    rlse, rll = tfx._plain_fwd(th, tw, tb, tl)
    plain = (rlse, rll) + tfx._plain_bwd(th, tw, tb, tl, rlse, tg)
    jax_out = _jax_kernels(h, w, b, lab, g)
    for name, a, p, j in zip(("lse", "ll", "dh", "dw", "db"), got, plain,
                             jax_out):
        _close(a, j, name + " vs JAX")
        _close(a, p, name + " vs plain")
    if ignored == 1.0:
        assert all(not x.abs().sum() for x in got[1:])


def test_three_term_model_meets_fused_xent_core():
    """The mean loss and its gradients against ``_fused_xent_core``, rows
    padded to its 256-row block with ignored rows (its wrapper's rule)."""
    h, w, b, lab, _ = _case(300, 128, 1024, 0.15, seed=5)
    lab_j = np.where(lab >= 0, lab, -100).astype(np.int32)
    pad = (-h.shape[0]) % 256
    hp = np.concatenate([h, np.zeros((pad, 128), np.float32)])
    lp = np.concatenate([lab_j, np.full(pad, -100, np.int32)])
    loss, vjp = jax.vjp(
        lambda a, c, d: jfx._fused_xent_core(a, c, d, jnp.asarray(lp),
                                             -100),
        jnp.asarray(hp), jnp.asarray(w), jnp.asarray(b))
    jdh, jdw, jdb = vjp(jnp.ones((), jnp.float32))
    th, tw, tb, tl = (torch.tensor(x) for x in (h, w, b, lab))
    valid = tl >= 0
    lse, ll = model_fwd(th, tw, tb, tl)
    count = valid.sum().float()
    mloss = torch.where(valid, lse - ll, torch.zeros_like(lse)).sum() / count
    dh, dw, db = model_bwd(th, tw, tb, tl, lse, valid.float() / count)
    _close(mloss.numpy(), np.asarray(loss), "loss")
    _close(dh, np.asarray(jdh)[:300], "dh")
    _close(dw, jdw, "dw")
    _close(db, jdb, "db")


def test_one_bf16_term_misses_the_card_tolerance():
    """At H 768 one bf16 term a product (P' rounded once too) moves the
    label logit, dh and dW past 1e-4 of their largest values: why every
    product takes three terms."""
    h, w, b, lab, g = _case(300, 768, 1000, 0.15, seed=7)
    th, tw, tb, tl, tg = (torch.tensor(x) for x in (h, w, b, lab, g))
    rlse, rll = tfx._plain_fwd(th, tw, tb, tl)
    want = (rll,) + tfx._plain_bwd(th, tw, tb, tl, rlse, tg)[:2]
    lse1, ll1 = model_fwd(th, tw, tb, tl, terms=1)
    got1 = (ll1,) + model_bwd(th, tw, tb, tl, rlse, tg, terms=1)[:2]
    lse3, ll3 = model_fwd(th, tw, tb, tl)
    got3 = (ll3,) + model_bwd(th, tw, tb, tl, rlse, tg)[:2]
    for name, one, three, ref in zip(("ll", "dh", "dw"), got1, got3, want):
        scale = float(ref.abs().max())
        assert float((one - ref).abs().max()) > TOL * scale, name
        assert float((three - ref).abs().max()) <= TOL * scale, name
