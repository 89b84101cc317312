"""A PyTorch model of the fused sampling kernel's cluster-wide radix
select (``paddle_tpu_torch/ops/cuda/csrc/sampling.cu``), run on the CPU:

- the same order-preserving u32 key (-0.0 keyed as +0.0), 8-bit digits
  from the top, the same slices of a row over a cluster of 8 CTAs, each
  slice's histogram of the active digit added in rank order, the bucket
  that holds rank k chosen from the top;
- held against ``torch.sort``'s k-th value (duplicates counted, the rule
  of ``lax.top_k``) for every k in 1..V, on seeded rows, tie-heavy rows,
  rows of +-0.0 and -inf, and Hypothesis rows, including V that the
  cluster does not divide and V smaller than the cluster;
- and the kernel's whole function (select, mask, noise, each slice's
  first maximum merged in rank order) against the plain version and the
  JAX package's ``_xla_sample`` under jit, bit for bit.

The kernel itself runs on the card only (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from paddle_tpu.ops.pallas import sampling as jsm
from paddle_tpu_torch.ops.cuda import sampling as tsm

CLUSTER = 8        # CTAs a row (sampling.cu kCluster)
BITS = 8           # digit width (kDigitBits)
BUCKETS = 1 << BITS
MASK32 = 0xFFFFFFFF


def slices(V, C=CLUSTER):
    """CTA q's [lo, hi): L = ceil(V / C) rounded up to a multiple of 4."""
    L = ((V + C - 1) // C + 3) & ~3
    return [(min(q * L, V), min(V, q * L + L)) for q in range(C)]


def order_keys(x):
    """(V,) int64 holding the u32 keys of an f32 row."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & MASK32
    u = torch.where(u == 0x80000000, torch.zeros_like(u), u)
    return torch.where((u & 0x80000000) != 0, ~u & MASK32, u | 0x80000000)


def key_value(k):
    """The f32 whose key is ``k`` (a Python int)."""
    u = (k & 0x7FFFFFFF) if k & 0x80000000 else (~k & MASK32)
    return torch.tensor([u - (1 << 32) if u >= 1 << 31 else u],
                        dtype=torch.int32).view(torch.float32)[0]


def radix_select(x, k, C=CLUSTER):
    """The k-th largest value of the row x (1 <= k <= V), as the
    cluster computes it."""
    keys = order_keys(x)
    parts = [keys[a:b] for a, b in slices(x.numel(), C)]
    prefix, want = 0, k
    for r in range(32 // BITS):
        shift = 32 - BITS * (r + 1)
        high = (MASK32 << (shift + BITS)) & MASK32
        total = torch.zeros(BUCKETS, dtype=torch.int64)
        for part in parts:                     # rank order
            live = part[(part & high) == prefix]
            total += torch.bincount((live >> shift) & (BUCKETS - 1),
                                    minlength=BUCKETS)
        from_top = total.flip(0)               # thread t: bucket 255 - t
        incl = torch.cumsum(from_top, 0)
        above = incl - from_top
        hit = torch.nonzero((above < want) & (want <= incl)).flatten()
        assert hit.numel() == 1
        j = int(hit[0])
        prefix |= (BUCKETS - 1 - j) << shift
        want -= int(above[j])
    return key_value(prefix)


def model_sample(logits, noise, temperature, top_k, C=CLUSTER):
    """The kernel's function on (B, V) f32 rows: int32 token ids."""
    inv_t = torch.tensor(float(tsm._inv_temperature(temperature)),
                         dtype=torch.float32)
    out = []
    for x, n in zip(logits * inv_t, noise):
        V = x.numel()
        if 0 < top_k < V:
            thr = radix_select(x, top_k, C)
            x = torch.where(x < thr, torch.full_like(x, -1e30), x)
        y = x + n
        best = None                            # (value, index)
        for a, b in slices(V, C):
            if a == b:
                continue
            i = int(torch.argmax(y[a:b]))      # the slice's first maximum
            c = (float(y[a + i]), a + i)
            if best is None or c[0] > best[0] or (c[0] == best[0]
                                                   and c[1] < best[1]):
                best = c
        out.append(best[1])
    return torch.tensor(out, dtype=torch.int32)


def _assert_every_k(x, C=CLUSTER, ks=None):
    srt = torch.sort(x, descending=True).values
    for k in ks or range(1, x.numel() + 1):
        thr = radix_select(x, k, C)
        kth = srt[k - 1]
        assert float(thr) == float(kth), (k, float(thr), float(kth))
        # the mask the threshold gives is the plain version's
        assert torch.equal(x < thr, x < kth), k


# ---------------------------------------------------------------------------
# the select against torch.sort, every k
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("V,seed", [(1000, 0), (1003, 1), (13, 2), (5, 3),
                                    (1, 4), (37, 5)])
def test_select_is_the_kth_of_sort_for_every_k(V, seed):
    """Seeded rows; 1003, 13 and 37 are not multiples of the cluster, 5
    and 1 leave CTAs with empty slices."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(V) * 3).astype(np.float32))
    _assert_every_k(x)


def test_select_on_tie_heavy_rows():
    """Many copies of one value straddle rank k from both sides, a
    duplicated maximum, +-0.0 mixed, and -inf logits."""
    rng = np.random.RandomState(7)
    x = (rng.randn(600) * 2).astype(np.float32)
    x[rng.choice(600, 150, replace=False)] = 0.75   # ranks ~100..250
    x[[5, 500]] = 9.0                               # a tied maximum
    x[rng.choice(600, 40, replace=False)] = 0.0
    x[rng.choice(600, 40, replace=False)] = -0.0
    x[rng.choice(600, 30, replace=False)] = -np.inf
    _assert_every_k(torch.from_numpy(x))


def test_select_on_signed_zeros_only_and_one_value():
    z = np.zeros(21, np.float32)
    z[::2] = -0.0
    _assert_every_k(torch.from_numpy(z))
    _assert_every_k(torch.full((19,), -3.5))
    _assert_every_k(torch.tensor([np.inf, -np.inf, 0.0, -0.0,
                                  np.float32(1e-45), np.float32(-1e-45),
                                  3.4e38, -3.4e38], dtype=torch.float32))


def test_select_keys_order_every_f32_class():
    """The key is monotone over one value of each class of f32, -0.0
    sharing +0.0's key, and key_value inverts it."""
    vals = torch.tensor([-np.inf, -3.4e38, -1.0, -1e-38, -1e-45, -0.0, 0.0,
                         1e-45, 1e-38, 1.0, 3.4e38, np.inf],
                        dtype=torch.float32)
    keys = order_keys(vals)
    assert bool((keys[1:] >= keys[:-1]).all())
    assert int(keys[5]) == int(keys[6])
    assert all(float(key_value(int(k))) == float(v)
               for k, v in zip(keys, vals))


def test_select_at_gpt2_width_at_the_edge_ranks():
    """V = 50257 (GPT-2's vocabulary), not a multiple of the cluster:
    ranks at the ends and around the main path's."""
    rng = np.random.RandomState(11)
    x = torch.from_numpy((rng.randn(50257) * 3).astype(np.float32))
    _assert_every_k(x, ks=[1, 2, 8, 50, 1024, 25128, 50256, 50257])


_VALUES = st.one_of(
    st.sampled_from([0.0, -0.0, 1.0, -1.0, 0.5, np.inf, -np.inf]),
    st.floats(width=32, allow_nan=False))


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.lists(_VALUES, min_size=1, max_size=90),
       st.sampled_from([1, 2, 3, 8]))
def test_select_hypothesis_rows_every_k(vals, C):
    """Any row of non-NaN f32 (ties, +-0.0, infinities, subnormals)
    over clusters of 1, 2, 3 and 8 CTAs."""
    _assert_every_k(torch.tensor(vals, dtype=torch.float32), C)


# ---------------------------------------------------------------------------
# the whole function against the plain version and JAX
# ---------------------------------------------------------------------------
_jit_sample = jax.jit(jsm._xla_sample, static_argnums=(2, 3, 4))


def _rows(B, V, seed, ties=False):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    if ties:
        logits[:, rng.choice(V, V // 4, replace=False)] = 1.25
        logits[:, :3] = 0.0
        logits[:, 3:6] = -0.0
        logits[:, 6:9] = -np.inf
        logits[0, [17, V - 1]] = 20.0
    noise = rng.gumbel(size=(B, V)).astype(np.float32)
    return torch.from_numpy(logits), torch.from_numpy(noise)


@pytest.mark.parametrize("temperature", [0.7, 1.0])
@pytest.mark.parametrize("V,ties", [(1000, False), (1003, True), (37, True)])
def test_model_sample_is_the_plain_version_and_jax(V, ties, temperature):
    """Bit for bit, for top_k in 0, 1, 4, 8, 50, V - 1 and V."""
    logits, noise = _rows(4, V, seed=V, ties=ties)
    for top_k in (0, 1, 4, 8, 50, V - 1, V):
        got = model_sample(logits, noise, temperature, top_k)
        plain = tsm._plain_sample(logits, noise, temperature, top_k, 1.0)
        ref = np.asarray(_jit_sample(jnp.asarray(logits.numpy()),
                                     jnp.asarray(noise.numpy()),
                                     temperature, top_k, 1.0))
        assert torch.equal(got, plain), top_k
        np.testing.assert_array_equal(got.numpy(), ref)
