"""The rounding of the tensor-core flash kernels (the bf16 forms of K1a's
and K1c's forward, of K1d and of K1b, ``csrc/flash_short.cu`` and
``csrc/flash_attention.cu``) modelled on the CPU and held against the JAX
kernels in interpret mode, so that the numerical design is checked
before it reaches the card.

The model (test-local, in f32 torch arithmetic) rounds exactly where the
kernels do and nowhere else:

- forward (``fwd_mma``, shared by K1a and K1c): each 64-row q tile's
  online softmax over the 64-column kv tiles it visits, S scaled in f32
  plus the (B, Lk) key bias, m and l in f32, l summing the unrounded
  probabilities; P = exp(S - m) (dropped and scaled by 1/(1-p)) into
  P V as two bf16 terms, hi + lo; Lq != Lk and ragged lengths. With a
  key bias the visited tiles follow ``kv_tile_visits``, the kernel's
  dead-tile rule, and skipping gives the same bits as visiting every
  tile (key-padded and causal batches; an entry with no live key and a
  causal left-padded entry are not skipped);
- backward: P = exp(S - lse) and dS = P (dP - delta) in f32; the dropped
  P rounded to bf16 into dV = P^T dO; dS into dQ = dS K and dK = dS^T Q
  as two bf16 terms, hi + lo (one bf16 rounding of dS misses the
  tolerance where a whole row is masked, as the last test shows);
- K1d's backward (``short_bwd_mma``, one thread-block cluster of L / 64
  CTAs a head): the same roundings tile pair by tile pair; CTA c keeps
  kv tile c and visits q tile j = (c + s) mod L/64 at step s (causal:
  j >= c only), and the owner of q tile j adds the f32 partials dS K_c
  of its visitors in step order (s = 0, 1, ...), as the cluster sums
  them through distributed shared memory; delta = rowsum(dO O) in f32
  from the bf16 output;
- inputs bf16 values, outputs rounded to bf16.

References: ``_fwd_call``, ``_flash_attention_core_short_fwd``,
``_flash_attention_core_short_bwd`` and ``_bwd_call`` with
``pl.pallas_call`` in interpret mode (f32, on the same bf16-valued
inputs), and the port's plain versions where dropout is on (the JAX
package's dropout bits are the TPU's, the port's Philox's). Tolerance:
the card checks' bf16 one, atol 2e-2 + rtol 1e-2, and lse within 1e-4.
Shapes: B 2-4, L 128-333, H 2, D 64 and 128.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.ops.cuda import flash_attention as tfa

TOL = dict(atol=2e-2, rtol=1e-2)
TILE = 64


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
    """x as the sum of two bf16 terms (hi, the rounded value; lo, its
    rounding error rounded)."""
    hi = bf(x)
    return hi + bf(x - hi)


def _inputs(B, L, H, D, seed, n=4):
    rng = np.random.RandomState(seed)
    return [bf(torch.tensor(rng.randn(B, L, H, D).astype(np.float32)))
            for _ in range(n)]


def _heads(x):
    B, L, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, L, D)


def _back(x, B, H):
    BH, L, D = x.shape
    return x.reshape(B, H, L, D).permute(0, 2, 1, 3)


def model_fwd(q, k, v, causal, p=0.0, seed=0, bias=None, skip=False):
    """The tensor-core forward (``fwd_mma``: K1a's ``flash_fwd_mma`` and
    K1c's ``short_fwd_mma``): (out in bf16 values, lse (B*H, Lq)). Each
    64-row q tile runs its own online softmax over the 64-key tiles it
    visits: all up to the diagonal, or with ``skip`` those
    ``kv_tile_visits`` names for the key ``bias``."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    keep = tfa.philox_keep_mask(seed, B * H, Lq, Lk, p).view(B, H, Lq, Lk) \
        if p > 0 else None
    visits = tfa.kv_tile_visits(B, Lq, Lk, causal, bias if skip else None)
    out = torch.zeros((B, H, Lq, D))
    lse = torch.zeros((B, H, Lq))
    for b in range(B):
        for qt in range(visits.shape[1]):
            rows = slice(qt * TILE, min(qt * TILE + TILE, Lq))
            row = torch.arange(rows.start, rows.stop).view(-1, 1)
            m = torch.full((H, row.shape[0], 1), -1e30)
            l = torch.zeros_like(m)
            o = torch.zeros((H, row.shape[0], D))
            for t in torch.nonzero(visits[b, qt]).flatten().tolist():
                cols = slice(t * TILE, min(t * TILE + TILE, Lk))
                s = (qh[b, :, rows] @ kh[b, :, cols].transpose(1, 2)) * scale
                if bias is not None:
                    s = s + bias[b, cols]
                if causal:
                    col = torch.arange(cols.start, cols.stop).view(1, -1)
                    s = s.masked_fill(col > row, float("-inf"))
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                pr = torch.exp(s - m_new)
                l = alpha * l + pr.sum(-1, keepdim=True)
                if keep is not None:
                    pr = torch.where(keep[b, :, rows, cols], pr / (1 - p),
                                     torch.zeros_like(pr))
                o = o * alpha + split(pr) @ vh[b, :, cols]
                m = m_new
            out[b, :, rows] = o / l
            lse[b, :, rows] = (m + torch.log(l)).squeeze(-1)
    return bf(out.permute(0, 2, 1, 3)), lse.reshape(B * H, Lq)


def model_bwd(q, k, v, dout, lse, delta, causal, p=0.0, seed=0, bias=None,
              ds_terms=2):
    """K1b's tensor-core backward from lse and delta ((B*H, Lq) f32):
    (dq, dk, dv) in bf16 values; ``ds_terms`` 1 rounds dS once."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    qm, km, vm, dom = _heads(q), _heads(k), _heads(v), _heads(dout)
    s = (qm @ km.transpose(1, 2)) * scale
    if bias is not None:
        s = s + bias.repeat_interleave(H, 0)[:, None, :]
    if causal:
        s = s.masked_fill(torch.ones(Lq, Lk, dtype=torch.bool).triu(1),
                          float("-inf"))
    prob = torch.exp(s - lse.unsqueeze(-1))
    dp = dom @ vm.transpose(1, 2)
    pd = prob
    if p > 0:
        keep = tfa.philox_keep_mask(seed, B * H, Lq, Lk, p)
        zero = torch.zeros_like(dp)
        dp = torch.where(keep, dp / (1 - p), zero)
        pd = torch.where(keep, prob / (1 - p), zero)
    ds = prob * (dp - delta.unsqueeze(-1))
    ds_op = split(ds) if ds_terms == 2 else bf(ds)
    dq = (ds_op @ km) * scale
    dk = (ds_op.transpose(1, 2) @ qm) * scale
    dv = bf(pd).transpose(1, 2) @ dom
    return tuple(bf(_back(x, B, H)) for x in (dq, dk, dv))


def _stats(q, k, v, dout, causal, bias=None):
    """lse and delta from the plain forward (f32)."""
    B, L, H, _ = q.shape
    out, lse = tfa._plain_fwd(q, k, v, causal, 0.0, 0, bias)
    delta = (dout * out).sum(-1).permute(0, 2, 1).reshape(B * H, L)
    return lse, delta.contiguous()


def _jax_bwd(q, k, v, dout, lse, delta, causal, bias=None):
    B, L, H, D = q.shape
    j = [jnp.asarray(_heads(x).numpy()) for x in (q, k, v, dout)]
    grads = jfa._bwd_call(
        *j, jnp.asarray(lse.numpy())[:, None, :],
        jnp.asarray(delta.numpy())[:, None, :], causal, 128, 128,
        1.0 / math.sqrt(D),
        mask_bias=None if bias is None
        else jnp.asarray(bias.numpy())[:, None, :], heads=H)
    return [_back(torch.tensor(np.asarray(g)), B, H) for g in grads]


def _close(got, want, what):
    err = float((got - want).abs().max())
    assert torch.allclose(got, want, **TOL), f"{what}: max abs err {err}"


@pytest.mark.parametrize("L,D,causal", [(256, 64, False), (256, 64, True),
                                        (128, 128, False)],
                         ids=["full", "causal", "D128"])
def test_forward_model_meets_the_card_tolerance(L, D, causal):
    q, k, v = _inputs(2, L, 2, D, seed=L + D + causal, n=3)
    jout, res = jfa._flash_attention_core_short_fwd(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), None, causal, 0.0)
    out, lse = model_fwd(q, k, v, causal)
    _close(out, bf(torch.tensor(np.asarray(jout))), "out")
    assert float((lse - torch.tensor(np.asarray(res[4])[:, 0])).abs().max()) \
        <= 1e-4


def test_forward_model_with_dropout_meets_the_card_tolerance():
    q, k, v = _inputs(2, 256, 2, 64, seed=3, n=3)
    out, lse = model_fwd(q, k, v, False, 0.1, 77)
    rout, rlse = tfa._plain_fwd(q, k, v, False, 0.1, 77)
    _close(out, bf(rout), "out")
    assert float((lse - rlse).abs().max()) <= 1e-4


def _jax_fwd(q, k, v, causal, bias=None):
    """``_fwd_call`` in interpret mode, one block over each whole
    length: (out, lse (B*H, Lq))."""
    B, Lq, H, D = q.shape
    jout, jlse = jfa._fwd_call(
        *(jnp.asarray(_heads(x).numpy()) for x in (q, k, v)), causal, Lq,
        k.shape[1], 1.0 / math.sqrt(D),
        mask_bias=None if bias is None
        else jnp.asarray(bias.numpy())[:, None, :], heads=H)
    return (_back(torch.tensor(np.asarray(jout)), B, H),
            torch.tensor(np.asarray(jlse))[:, 0])


def _key_bias(B, L, starts, ends):
    """kv_mask_bias of keys [starts[b], ends[b]) live."""
    col = torch.arange(L)[None, :]
    return tfa.kv_mask_bias((col >= torch.tensor(starts)[:, None])
                            & (col < torch.tensor(ends)[:, None]), B, L)


@pytest.mark.parametrize("Lq,Lk,D,causal,masked", [
    (128, 200, 64, False, False), (200, 200, 64, True, False),
    (200, 200, 128, True, False), (128, 128, 128, False, True),
    (256, 256, 64, True, True)],
    ids=["Lq-ne-Lk", "ragged-causal", "ragged-causal-D128", "D128-masked",
         "causal-masked"])
def test_streaming_forward_model_meets_the_card_tolerance(Lq, Lk, D, causal,
                                                          masked):
    """K1a's forward (Lq != Lk, a ragged L, D 64 and 128, causal, a key
    bias; dead tiles skipped) against ``_fwd_call`` in interpret mode."""
    seed = Lq + Lk + D + causal
    q = _inputs(2, Lq, 2, D, seed, n=1)[0]
    k, v = _inputs(2, Lk, 2, D, seed + 1, n=2)
    bias = _key_bias(2, Lk, [0, 0], [Lk, 97]) if masked else None
    out, lse = model_fwd(q, k, v, causal, bias=bias, skip=True)
    jout, jlse = _jax_fwd(q, k, v, causal, bias)
    _close(out, bf(jout), "out")
    assert float((lse - jlse).abs().max()) <= 1e-4


def _int_bits(x):
    return x.contiguous().view(torch.int32)


# (causal, first live key, end of the live keys) of 4 batch entries of 256
_SKIP_CASES = {
    "key-padded": (False, [0, 0, 0, 0], [256, 97, 1, 160]),
    "causal-live-first": (True, [0, 0, 0, 0], [256, 97, 1, 160]),
    "no-live-key": (False, [0, 0, 0, 0], [256, 0, 70, 0]),
    "causal-left-padded": (True, [0, 100, 3, 200], [256, 256, 256, 256]),
}


@pytest.mark.parametrize("case", list(_SKIP_CASES))
def test_dead_tile_skip_gives_the_same_bits(case):
    """The kernel's f32 order of operations, with and without skipping
    the tiles ``kv_tile_visits`` drops: the same bits, and the plain
    version within the card tolerance. An entry with no live key (the
    mean of V) and a causal entry whose first live key lies past a q
    tile's first row are not skipped."""
    causal, starts, ends = _SKIP_CASES[case]
    q, k, v = _inputs(4, 256, 2, 64, seed=len(case), n=3)
    bias = _key_bias(4, 256, starts, ends)
    full = tfa.kv_tile_visits(4, 256, 256, causal)
    visits = tfa.kv_tile_visits(4, 256, 256, causal, bias)
    assert bool((visits <= full).all()) and int((full & ~visits).sum()) > 0
    for b in range(4):
        first = starts[b] if ends[b] > starts[b] else 256
        for qt in range(visits.shape[1]):
            kept = causal and first > TILE * qt or first == 256
            assert not kept or torch.equal(visits[b, qt], full[b, qt])
    plain, plain_lse = model_fwd(q, k, v, causal, 0.1, 9, bias)
    out, lse = model_fwd(q, k, v, causal, 0.1, 9, bias, skip=True)
    assert torch.equal(_int_bits(out), _int_bits(plain))
    assert torch.equal(_int_bits(lse), _int_bits(plain_lse))
    rout, rlse = tfa._plain_fwd(q, k, v, causal, 0.1, 9, bias)
    _close(out, bf(rout), "out")
    assert float((lse - rlse).abs().max()) <= 1e-4


@pytest.mark.parametrize("causal,masked", [(False, False), (True, False),
                                           (False, True), (True, True)],
                         ids=["full", "causal", "masked", "causal-masked"])
def test_backward_model_meets_the_card_tolerance(causal, masked):
    q, k, v, do = _inputs(2, 256, 2, 64, seed=11 + 2 * causal + masked)
    bias = tfa.kv_mask_bias(torch.arange(256)[None, :]
                            < torch.tensor([[256], [97]]), 2, 256) \
        if masked else None
    lse, delta = _stats(q, k, v, do, causal, bias)
    got = model_bwd(q, k, v, do, lse, delta, causal, bias=bias)
    want = _jax_bwd(q, k, v, do, lse, delta, causal, bias)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, bf(b), name)


def test_backward_model_with_dropout_meets_the_card_tolerance():
    q, k, v, do = _inputs(2, 128, 2, 64, seed=21)
    out, lse = tfa._plain_fwd(q, k, v, False, 0.1, 78)
    delta = (do * out).sum(-1).permute(0, 2, 1).reshape(4, 128)
    got = model_bwd(q, k, v, do, lse, delta, False, 0.1, 78)
    want = tfa._plain_bwd(q, k, v, out, lse, do, False, 0.1, 78)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, bf(b), name)


def test_a_fully_masked_row_needs_ds_in_two_terms():
    """Where every key of a batch row is masked, its saved lse is -1e30
    and P is 1 across the row, so dS is Lk times its usual size: one bf16
    rounding of dS moves dQ and dK past the tolerance, hi + lo does not."""
    q, k, v, do = _inputs(2, 256, 2, 64, seed=13)
    bias = tfa.kv_mask_bias(torch.arange(256)[None, :]
                            < torch.tensor([[256], [0]]), 2, 256)
    lse, delta = _stats(q, k, v, do, False, bias)
    assert bool((lse.view(2, 2, 256)[1] == np.float32(-1e30)).all())
    want = [bf(g) for g in _jax_bwd(q, k, v, do, lse, delta, False, bias)]
    two = model_bwd(q, k, v, do, lse, delta, False, bias=bias)
    one = model_bwd(q, k, v, do, lse, delta, False, bias=bias, ds_terms=1)
    for name, a, b in zip(("dq", "dk", "dv"), two, want):
        _close(a, b, name)
    assert not torch.allclose(one[0], want[0], **TOL)
    assert not torch.allclose(one[1], want[1], **TOL)


def model_short_bwd(q, k, v, out, dout, lse, causal, p=0.0, seed=0):
    """K1d's tensor-core backward (one cluster a head, see the module
    docstring): (dq, dk, dv) in bf16 values."""
    B, L, H, D = q.shape
    n, scale = L // TILE, 1.0 / math.sqrt(D)
    qm, km, vm, dom, om = (_heads(x) for x in (q, k, v, dout, out))
    delta = (dom * om).sum(-1)
    keep = tfa.philox_keep_mask(seed, B * H, L, L, p) if p > 0 else None
    dk, dv = torch.zeros_like(km), torch.zeros_like(vm)
    ds_tiles = {}
    for c in range(n):                        # CTA c: kv tile c
        cols = slice(c * TILE, (c + 1) * TILE)
        for st in range(n):
            j = (c + st) % n
            if causal and j < c:
                continue
            rows = slice(j * TILE, (j + 1) * TILE)
            sc = (qm[:, rows] @ km[:, cols].transpose(1, 2)) * scale
            prob = torch.exp(sc - lse[:, rows, None])
            if causal:
                dead = torch.arange(c * TILE, (c + 1) * TILE)[None, :] > \
                    torch.arange(j * TILE, (j + 1) * TILE)[:, None]
                prob = prob.masked_fill(dead, 0.0)
            dp = dom[:, rows] @ vm[:, cols].transpose(1, 2)
            pd = prob
            if keep is not None:
                kt = keep[:, rows, cols]
                dp = torch.where(kt, dp / (1 - p), torch.zeros_like(dp))
                pd = torch.where(kt, prob / (1 - p), torch.zeros_like(dp))
            ds = split(prob * (dp - delta[:, rows, None]))
            ds_tiles[j, c] = ds
            dv[:, cols] += bf(pd).transpose(1, 2) @ dom[:, rows]
            dk[:, cols] += ds.transpose(1, 2) @ qm[:, rows]
    dq = torch.zeros_like(qm)
    for j in range(n):                        # owner j, visitors in order
        rows = slice(j * TILE, (j + 1) * TILE)
        for st in range(n):
            c = (j - st) % n
            if (j, c) in ds_tiles:
                dq[:, rows] += ds_tiles[j, c] @ km[:, c * TILE:(c + 1) * TILE]
    return tuple(bf(_back(x, B, H))
                 for x in (dq * scale, dk * scale, dv))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("L,D", [(128, 64), (256, 64), (128, 128),
                                 (256, 128)])
def test_short_backward_model_meets_the_card_tolerance(L, D, causal):
    """K1d's model against ``_flash_attention_core_short_bwd`` in
    interpret mode from the same (JAX) forward: clusters of 2 and 4."""
    q, k, v, do = _inputs(2, L, 2, D, seed=L + D + 5 * causal)
    jq, jk, jv, jdo = (jnp.asarray(x.numpy()) for x in (q, k, v, do))
    jout, res = jfa._flash_attention_core_short_fwd(jq, jk, jv, None,
                                                    causal, 0.0)
    want = jfa._flash_attention_core_short_bwd(causal, 0.0, res, jdo)[:3]
    out = bf(torch.tensor(np.asarray(jout)))
    lse = torch.tensor(np.asarray(res[4])[:, 0])
    got = model_short_bwd(q, k, v, out, do, lse, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, bf(torch.tensor(np.asarray(b))), name)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_short_backward_model_with_dropout_meets_the_card_tolerance(causal):
    """With dropout 0.1, against the port's plain version (the JAX
    package's dropout bits are the TPU's), at L 256: a cluster of 4."""
    q, k, v, do = _inputs(2, 256, 2, 64, seed=31 + causal)
    out, lse = tfa._plain_fwd(q, k, v, causal, 0.1, 79)
    got = model_short_bwd(q, k, v, bf(out), do, lse, causal, 0.1, 79)
    want = tfa._plain_bwd(q, k, v, out, lse, do, causal, 0.1, 79)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, bf(b), name)
