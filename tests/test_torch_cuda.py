"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs, and the no-fallback rule: a CUDA tensor the
kernel does not take raises, it never runs the plain version.

Needs an NVIDIA GPU (marker ``cuda``): without one every test skips. Imports
neither JAX nor paddle_tpu, so on the machine with the card it runs
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from paddle_tpu_torch.ops.cuda import sampling as sm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    counters.reset()
    return torch.device("cuda")


def _case(dev, seed, B, H, D, S, T, lens, quant):
    rng = np.random.RandomState(seed)
    P = B * T + 1
    table = np.full((B, T), -1, np.int32)
    for b, n in enumerate(lens):
        live = -(-n // S)
        table[b, :live] = 1 + b * T + np.arange(live)
    if -(-max(lens) // S) > 1:
        table[int(np.argmax(lens)), 0] = -1   # inside the live length
    q = torch.tensor(rng.randn(B, H, D).astype(np.float32), device=dev)
    if quant:
        pools = [torch.tensor(rng.randint(-127, 128, (P, S, H, D)),
                              dtype=torch.int8, device=dev)
                 for _ in range(2)]
        scales = [torch.tensor(rng.uniform(0.001, 0.03, (P, S)),
                               dtype=torch.float32, device=dev)
                  for _ in range(2)]
    else:
        pools = [torch.tensor(rng.randn(P, S, H, D).astype(np.float32),
                              device=dev) for _ in range(2)]
        scales = [None, None]
    return (q, *pools, torch.tensor(table, device=dev),
            torch.tensor(np.asarray(lens, np.int32), device=dev), *scales)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("B,H,D,S,T,lens", [
    (3, 4, 64, 16, 5, [1, 17, 80]),
    (2, 2, 256, 8, 4, [32, 9]),
    (4, 3, 40, 128, 3, [129, 1, 384, 255]),
    (8, 16, 128, 128, 16, [1, 127, 128, 129, 700, 2047, 1500, 300]),
], ids=["S16-D64", "D256", "odd-H-D40", "full-width"])
def test_paged_attention_kernel_matches_plain(dev, quant, B, H, D, S, T,
                                              lens):
    q, kp, vp, table, lens_t, ks, vs = _case(dev, 7, B, H, D, S, T, lens,
                                             quant)
    out = pa.paged_attention(q, kp, vp, table, lens_t, k_scales=ks,
                             v_scales=vs)
    if quant:
        ref = pa._plain_paged_attention_quant(q, kp, vp, ks, vs, table,
                                              lens_t)
    else:
        ref = pa._plain_paged_attention(q, kp, vp, table, lens_t)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    assert counters.get("paged_attention_quant" if quant
                        else "paged_attention") == 1
    again = pa.paged_attention(q, kp, vp, table, lens_t, k_scales=ks,
                               v_scales=vs)
    assert torch.equal(out, again)     # one launch, no atomics


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("B,H,D,S,T,lens", [
    (3, 4, 64, 16, 5, [1, 17, 80]),
    (2, 2, 256, 8, 4, [32, 9]),
    (4, 3, 44, 128, 3, [129, 1, 384, 255]),
    (8, 16, 128, 128, 16, [1, 127, 128, 129, 700, 2047, 1500, 300]),
], ids=["S16-D64", "D256", "odd-H-D44", "full-width"])
def test_paged_attention_kernel_over_2_byte_pools_matches_plain(
        dev, dtype, B, H, D, S, T, lens):
    """K4a over bf16 and f16 pages (the pools of a ``dtype="bfloat16"``
    or ``"float16"`` engine): the kernel unpacks the pages to f32 and the
    plain version upcasts them, so the two differ by the sum order only
    (1e-4). D 44 takes the 4-byte copies (a row is not a multiple of 16
    bytes)."""
    q, kp, vp, table, lens_t, _, _ = _case(dev, 7, B, H, D, S, T, lens,
                                           False)
    kp, vp = kp.to(dtype), vp.to(dtype)
    out = pa.paged_attention(q, kp, vp, table, lens_t)
    ref = pa._plain_paged_attention(q, kp, vp, table, lens_t)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    name = "paged_attention_bf16" if dtype == torch.bfloat16 \
        else "paged_attention_f16"
    assert counters.snapshot() == {name: 1}
    assert torch.equal(out, pa.paged_attention(q, kp, vp, table, lens_t))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_paged_attention_kernel_gives_zeros_at_len_0(dev, quant):
    """len 0 is outside the contract: every CTA of the cluster has an
    empty stripe and the row is zeros (the plain version's is the mean
    of the gathered V rows); the other rows agree, one of them longer
    than its table's T * S = 80 tokens (pages past T are not read)."""
    q, kp, vp, table, lens_t, ks, vs = _case(dev, 8, 3, 4, 64, 16, 5,
                                             [0, 17, 80], quant)
    lens_t[2] = 100
    out = pa.paged_attention(q, kp, vp, table, lens_t, k_scales=ks,
                             v_scales=vs)
    ref = pa._plain_paged_attention_quant(q, kp, vp, ks, vs, table, lens_t) \
        if quant else pa._plain_paged_attention(q, kp, vp, table, lens_t)
    torch.cuda.synchronize()
    assert not out[0].any()
    torch.testing.assert_close(out[1:], ref[1:], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("temperature", [0.7, 1.0, 1.7])
@pytest.mark.parametrize("top_k", [0, 1, 4, 8, 100])
def test_sampling_kernel_is_bitwise_the_plain_version(dev, top_k,
                                                      temperature):
    rng = np.random.RandomState(top_k)
    logits = torch.tensor((rng.randn(8, 32000) * 3).astype(np.float32),
                          device=dev)
    noise = torch.tensor(rng.gumbel(size=(8, 32000)).astype(np.float32),
                         device=dev)
    out = sm.fused_sample(logits, noise, temperature, top_k)
    ref = sm._plain_sample(logits, noise, temperature, top_k, 1.0)
    assert torch.equal(out, ref)
    assert counters.get("fused_sample") == 1


def _tie_rows(rng, B, V):
    """Rows of copies of one value straddling ranks 8 and 50, a tied
    maximum, +-0.0 at ranks 50 and up, -inf logits."""
    x = (rng.randn(B, V) * 3).astype(np.float32)
    for b in range(B):
        top = np.sort(x[b])[::-1]
        kind = b % 4
        if kind == 0:
            x[b, rng.choice(V, min(60, V), replace=False)] = \
                top[min(40, V - 1)]
        elif kind == 1:
            x[b, rng.choice(V, 3, replace=False)] = top[0] + 1.0
        elif kind == 2:
            x[b] = -np.abs(x[b]) - 1.0
            x[b, :30] = 5.0
            x[b, 30:V // 2] = 0.0
            x[b, V // 2:] = -0.0
        else:
            x[b, rng.choice(V, V // 2, replace=False)] = -np.inf
    return x


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("V", [5, 13, 1003, 32000, 50257, 262147])
def test_sampling_cluster_kernel_is_bitwise_the_plain_version(dev, V, ties):
    """The cluster of 8 CTAs at every V shape it meets: fewer elements
    than CTAs, a V the cluster does not divide, the engine's 32000,
    GPT-2's 50257, and 262147, whose slices outgrow shared memory and
    are read from device memory in each round; top_k 0, 1, 4, 8, 50,
    1024, V - 1 and V; one launch a call, a relaunch equal."""
    rng = np.random.RandomState(V)
    B = 4
    x = _tie_rows(rng, B, V) if ties else \
        (rng.randn(B, V) * 3).astype(np.float32)
    logits = torch.tensor(x, device=dev)
    noise = torch.tensor(rng.gumbel(size=(B, V)).astype(np.float32),
                         device=dev)
    ks = sorted({k for k in (0, 1, 4, 8, 50, 1024, V - 1, V) if k >= 0})
    for top_k in ks:
        for temperature in (0.7, 1.0):
            counters.reset()
            out = sm.fused_sample(logits, noise, temperature, top_k)
            assert counters.get("fused_sample") == 1
            again = sm.fused_sample(logits, noise, temperature, top_k)
            ref = sm._plain_sample(logits, noise, temperature, top_k, 1.0)
            assert torch.equal(out, ref), (top_k, temperature)
            assert torch.equal(out, again)


def test_sampling_kernel_counts_duplicates_in_top_k(dev):
    logits = torch.full((1, 300), -5.0, device=dev)
    logits[0, [3, 9, 40]] = 5.0
    logits[0, 77] = 1.0
    noise = torch.zeros_like(logits)
    noise[0, 77] = 50.0
    assert sm.fused_sample(logits, noise, 1.0, 2).tolist() == [3]


def test_cuda_tensors_the_kernels_do_not_take_raise(dev):
    q, kp, vp, table, lens, _, _ = _case(dev, 1, 2, 2, 320, 8, 2, [3, 9],
                                         False)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(q, kp, vp, table, lens)
    q, kp, vp, table, lens, _, _ = _case(dev, 1, 2, 2, 32, 8, 2, [3, 9],
                                         False)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(q, kp, vp, table.long(), lens)
    with pytest.raises(TypeError):
        pa.paged_attention(q.double(), kp, vp, table, lens)
    with pytest.raises(ValueError, match="contiguous"):
        sm.fused_sample(torch.zeros((4, 64), device=dev).t(),
                        torch.zeros((64, 4), device=dev), 1.0, 2)
    assert counters.snapshot() == {}


# ---------------------------------------------------------------------------
# the training slices: flash attention, fused xent, fused Adam and
# Momentum
# ---------------------------------------------------------------------------
from paddle_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops.cuda import fused_optimizer as fo  # noqa: E402
from paddle_tpu_torch.ops.cuda import fused_xent as fx  # noqa: E402


def _qkvo(dev, seed, B, L, H, D, dtype):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((B, L, H, D), generator=g, device=dev).to(dtype)
            for _ in range(4)]


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,L,H,D,causal,p", [
    (2, 128, 12, 64, False, 0.0),
    (2, 128, 12, 64, False, 0.1),
    (1, 200, 3, 64, True, 0.1),
    (1, 96, 2, 128, False, 0.0),
    (1, 200, 2, 192, True, 0.1),
    (1, 256, 2, 256, False, 0.1),
], ids=["bert", "bert-dropout", "ragged-causal", "D128", "D192-causal",
        "D256"])
def test_flash_kernels_match_plain(dev, dtype, atol, B, L, H, D, causal, p):
    q, k, v, do = _qkvo(dev, 11, B, L, H, D, dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, causal, p, 1234)
    rout, rlse = fa._plain_fwd(q, k, v, causal, p, 1234)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, p, 1234)
    rgrads = fa._plain_bwd(q, k, v, rout, rlse, do, causal, p, 1234)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), rout.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    for got, want in zip(grads, rgrads):
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=atol)
    assert counters.get("flash_attention_fwd") == 1
    assert counters.get("flash_attention_bwd") == 1


def test_flash_kernel_dropout_mask_is_bitwise_the_plain_mask(dev):
    L, p = 64, 0.1
    z = torch.zeros((3, L, 2, 64), device=dev)
    v = torch.eye(L, device=dev).reshape(1, L, 1, 64).expand(3, L, 2, 64)
    out = fa.flash_attention(z, z, v.contiguous(), dropout_p=p, seed=77)
    keep = fa.philox_keep_mask(77, 6, L, L, p, dev)
    got = (out > 0).permute(0, 2, 1, 3).reshape(6, L, L)
    assert torch.equal(got, keep)


def test_fused_xent_kernels_match_plain(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    N, H, V = 300, 128, 1000
    h = torch.randn((N, H), generator=g, device=dev) * 0.2
    w = torch.randn((V, H), generator=g, device=dev) * 0.2
    b = torch.randn((V,), generator=g, device=dev) * 0.1
    lab = torch.randint(0, V, (N,), generator=g, device=dev,
                        dtype=torch.int32)
    lab[::7] = -1
    gr = torch.rand((N,), generator=g, device=dev) * (lab >= 0)
    lse, ll = fx.fused_xent_fwd(h, w, b, lab)
    rlse, rll = fx._plain_fwd(h, w, b, lab)
    got = fx.fused_xent_bwd(h, w, b, lab, lse, gr)
    want = fx._plain_bwd(h, w, b, lab, rlse, gr)
    torch.cuda.synchronize()
    for x, y in zip((lse, ll) + tuple(got), (rlse, rll) + tuple(want)):
        assert (x - y).abs().max() <= 1e-4 * y.abs().max()
    assert counters.get("fused_xent_fwd") == 1
    assert counters.get("fused_xent_bwd") == 1


@pytest.mark.parametrize("N,H,V,ignored", [
    (1000, 768, 3001, 0.15),
    (300, 16, 1000, 0.15),
    (200, 1024, 777, 0.15),
    (257, 768, 500, 1.0),
], ids=["H768-ragged", "H16", "H1024", "all-ignored"])
def test_tensor_core_xent_matches_plain_and_is_deterministic(dev, N, H, V,
                                                             ignored):
    """K2a/K2b on tensor cores (three bf16 terms a product, H split over a
    cluster of ceil(H / 256) CTAs) against the plain version within 1e-4
    of each output's largest value, with N and V no multiple of a tile, at
    the shape rule's edges and with every row ignored (dh, dW and db
    exactly zero); a second launch gives the same bits; one count a
    call."""
    g = torch.Generator(device=dev).manual_seed(40)
    h = torch.randn((N, H), generator=g, device=dev)
    w = torch.randn((V, H), generator=g, device=dev) * 0.02
    b = torch.randn((V,), generator=g, device=dev) * 0.02
    lab = torch.randint(0, V, (N,), generator=g, device=dev,
                        dtype=torch.int32)
    drop = torch.rand((N,), generator=g, device=dev) < ignored
    lab = torch.where(drop, torch.full_like(lab, -1), lab)
    gr = (lab >= 0).float() / (lab >= 0).sum().clamp(min=1).float()
    first = fx.fused_xent_fwd(h, w, b, lab)
    first += fx.fused_xent_bwd(h, w, b, lab, first[0], gr)
    assert counters.snapshot() == {"fused_xent_fwd": 1, "fused_xent_bwd": 1}
    second = fx.fused_xent_fwd(h, w, b, lab)
    second += fx.fused_xent_bwd(h, w, b, lab, second[0], gr)
    rlse, rll = fx._plain_fwd(h, w, b, lab)
    want = (rlse, rll) + fx._plain_bwd(h, w, b, lab, rlse, gr)
    torch.cuda.synchronize()
    for name, x, y, z in zip(("lse", "ll", "dh", "dw", "db"), first, second,
                             want):
        assert bool(torch.isfinite(x).all()), name
        assert float((x - z).abs().max()) <= 1e-4 * float(z.abs().max()), \
            name
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), name
    if ignored == 1.0:
        assert all(int(torch.count_nonzero(x)) == 0 for x in first[1:])
    assert counters.snapshot() == {"fused_xent_fwd": 2, "fused_xent_bwd": 2}


def test_fused_adam_kernel_is_bitwise_the_plain_version(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    shapes = [(30592, 64), (768,), (3,), (0,), (1000, 7)]
    ps = [torch.randn(s, generator=g, device=dev) for s in shapes]
    gs = [torch.randn(s, generator=g, device=dev) * 0.01 for s in shapes]
    ms = [torch.randn(s, generator=g, device=dev) * 0.01 for s in shapes]
    vs = [torch.rand(s, generator=g, device=dev) * 1e-4 for s in shapes]
    kp, km, kv = ([x.clone() for x in xs] for xs in (ps, ms, vs))
    kw = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, step=3,
              weight_decay=0.01)
    fo.fused_adam_(kp, gs, km, kv, **kw)
    lr, c1, c2, lrwd = fo.adam_scalars(1e-4, 0.9, 0.999, 3, 0.01)
    fo._plain_adam_(ps, gs, ms, vs, lr, 0.9, 0.999, 1e-8, c1, c2, lrwd,
                    False)
    torch.cuda.synchronize()
    for a, b in zip(kp + km + kv, ps + ms + vs):
        assert torch.equal(a, b)
    assert counters.get("fused_adam") == 1


@pytest.mark.parametrize("nesterov", [False, True], ids=["plain", "nesterov"])
def test_fused_momentum_kernel_is_bitwise_the_plain_version(dev, nesterov):
    g = torch.Generator(device=dev).manual_seed(6)
    shapes = [(2048, 512, 1, 1), (64,), (3,), (0,), (1000, 7)]
    ps = [torch.randn(s, generator=g, device=dev) for s in shapes]
    vs = [torch.randn(s, generator=g, device=dev) * 0.01 for s in shapes]
    kp, kv = [x.clone() for x in ps], [x.clone() for x in vs]
    cache = {}
    for step in range(3):
        gs = [torch.randn(s, generator=g, device=dev) * 0.01 for s in shapes]
        fo.fused_momentum_(kp, gs, kv, lr=0.1, momentum=0.9,
                           nesterov=nesterov, cache=cache)
        fo._plain_momentum_(ps, gs, vs, np.float32(0.1), np.float32(0.9),
                            nesterov, False)
    fo.fused_momentum_(kp, gs, kv, lr=0.1, momentum=0.9, nesterov=nesterov,
                       skip=True, cache=cache)
    torch.cuda.synchronize()
    for a, b in zip(kp + kv, ps + vs):
        assert torch.equal(a, b)
    assert counters.get("fused_momentum") == 3


def test_training_kernels_raise_on_what_they_do_not_take(dev):
    q = torch.zeros((1, 64, 2, 96), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    # every flash kernel takes f16; f64, a mix of types, and a length the
    # short kernels do not take are refused
    q = torch.zeros((1, 64, 2, 64), device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 128, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError, match="one type"):
        fa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="short"):
        fa.flash_attention_short(q[:, :64].contiguous(),
                                 q[:, :64].contiguous(),
                                 q[:, :64].contiguous())
    h = torch.zeros((4, 100), device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        fx.fused_xent_fwd(h, torch.zeros((8, 100), device=dev),
                          torch.zeros(8, device=dev),
                          torch.zeros(4, dtype=torch.int32, device=dev))
    h = torch.zeros((4, 1040), device=dev)
    with pytest.raises(ValueError, match="from 16 to 1024"):
        fx.fused_xent_fwd(h, torch.zeros((8, 1040), device=dev),
                          torch.zeros(8, device=dev),
                          torch.zeros(4, dtype=torch.int32, device=dev))
    p = torch.zeros(8, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="f32"):
        fo.fused_adam_([p], [p], [p], [p], lr=1e-3, beta1=0.9, beta2=0.999,
                       eps=1e-8, step=1)
    with pytest.raises(ValueError, match="f32"):
        fo.fused_momentum_([p], [p], [p], lr=0.1, momentum=0.9,
                           nesterov=False)
    w = torch.zeros((8, 4), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fo.fused_momentum_([w.t()], [w.t()], [w.t()], lr=0.1, momentum=0.9,
                           nesterov=False)
    with pytest.raises(ValueError, match="shapes differ"):
        fo.fused_momentum_([w], [torch.zeros(32, device=dev)], [w], lr=0.1,
                           momentum=0.9, nesterov=False)
    assert counters.snapshot() == {}


# ---------------------------------------------------------------------------
# the short-sequence flash kernels, SGD and Lamb
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,atol,B,L,H,D,causal,p", [
    (torch.bfloat16, 2e-2, 2, 512, 12, 64, False, 0.1),
    (torch.float32, 1e-4, 2, 128, 12, 64, False, 0.0),
    (torch.float32, 1e-4, 1, 256, 3, 64, True, 0.1),
    (torch.bfloat16, 2e-2, 1, 384, 2, 128, False, 0.1),
    (torch.bfloat16, 2e-2, 1, 512, 2, 192, False, 0.1),
    (torch.float32, 1e-4, 1, 256, 2, 256, True, 0.1),
    (torch.bfloat16, 2e-2, 1, 384, 2, 256, True, 0.0),
], ids=["bert512", "L128", "causal", "D128", "D192", "D256-f32-causal",
        "D256-causal"])
def test_flash_short_kernels_match_plain_and_streaming(dev, dtype, atol, B,
                                                       L, H, D, causal, p):
    q, k, v, do = _qkvo(dev, 12, B, L, H, D, dtype)
    out, lse = fa.flash_attention_short_fwd(q, k, v, causal, p, 4321)
    rout, rlse = fa._plain_fwd(q, k, v, causal, p, 4321)
    sout, slse = fa.flash_attention_fwd(q, k, v, causal, p, 4321)
    grads = fa.flash_attention_short_bwd(q, k, v, out, lse, do, causal, p,
                                         4321)
    rgrads = fa._plain_bwd(q, k, v, rout, rlse, do, causal, p, 4321)
    sgrads = fa.flash_attention_bwd(q, k, v, sout, slse, do, causal, p, 4321)
    torch.cuda.synchronize()
    for ref_out, ref_lse, ref_grads in ((rout, rlse, rgrads),
                                        (sout, slse, sgrads)):
        torch.testing.assert_close(out.float(), ref_out.float(), atol=atol,
                                   rtol=atol)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
        for got, want in zip(grads, ref_grads):
            torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                       rtol=atol)
    assert counters.get("flash_attention_short_fwd") == 1
    assert counters.get("flash_attention_short_bwd") == 1


def test_flash_short_dropout_mask_is_bitwise_the_plain_mask(dev):
    L, p = 128, 0.1
    z = torch.zeros((2, L, 2, L), device=dev)
    v = torch.eye(L, device=dev).reshape(1, L, 1, L).expand(2, L, 2, L)
    out = fa.flash_attention_short(z, z, v.contiguous(), dropout_p=p,
                                   seed=78)
    keep = fa.philox_keep_mask(78, 4, L, L, p, dev)
    got = (out > 0).permute(0, 2, 1, 3).reshape(4, L, L)
    assert torch.equal(got, keep)


def _offset_copy(x):
    """A copy as far from 16-byte alignment as ``x`` (an offset view
    stays on the walker's scalar path)."""
    off = x.data_ptr() % 16 // 4
    return torch.empty(x.numel() + off, device=x.device)[off:].view(
        x.shape).copy_(x)


@pytest.mark.parametrize("wd", [0.0, 1e-4])
def test_fused_sgd_kernel_is_bitwise_the_plain_version(dev, wd):
    """Three steps and a skipped one over tensors of odd sizes, an empty
    one and an offset view (the scalar path) included, without and with
    the coupled decay: p bit for bit; one launch a step, none skipped;
    the last launch covered every tensor."""
    g = torch.Generator(device=dev).manual_seed(7)
    shapes = [(6, 1, 3, 3), (6,), (3,), (0,), (1000, 7), (4099,)]
    ps = [torch.randn(s, generator=g, device=dev) for s in shapes]
    ps[-1] = torch.randn(4100, generator=g, device=dev)[1:]
    kp = [_offset_copy(x) for x in ps]
    assert kp[-1].data_ptr() % 16 == 4
    cover = {"tensors": len(shapes),
             "elements": sum(int(np.prod(s)) for s in shapes)}
    for _ in range(3):
        gs = [torch.randn(s, generator=g, device=dev) * 0.01 for s in shapes]
        assert fo.fused_sgd_(kp, gs, lr=0.01, weight_decay=wd) == dict(
            cover, launches=1)
        fo._plain_sgd_(ps, gs, np.float32(0.01), np.float32(wd), False)
    assert fo.fused_sgd_(kp, gs, lr=0.01, weight_decay=wd,
                         skip=True) == dict(cover, launches=0)
    torch.cuda.synchronize()
    for a, b in zip(kp, ps):
        assert torch.equal(a, b)
    assert counters.get("fused_sgd") == 3


def test_fused_sgd_splits_a_list_past_the_table_capacity(dev):
    """A list of more tensors than one launch's table holds by value
    (``static_capacity(2)``: 1,359 with CUDA 12.1's parameter space)
    runs as consecutive launches, each counted, bit for bit the plain
    version with the decay; every fifth tensor an offset view."""
    cap = fo.static_capacity(2)
    assert cap == (((fo.static_param_bytes() - 128) // 8) - 1) // 3
    n = cap + 41
    g = torch.Generator(device=dev).manual_seed(17)
    sizes = [1 + k % 9 for k in range(n)]

    def tensors(scale):
        out = []
        for k, m in enumerate(sizes):
            x = torch.randn(m + 1, generator=g, device=dev) * scale
            out.append(x[1:] if k % 5 == 0 else x[:m])
        return out

    ps, gs = tensors(1.0), tensors(0.01)
    kp = [_offset_copy(x) for x in ps]
    assert sum(x.data_ptr() % 16 != 0 for x in kp) == -(-n // 5)
    rec = fo.fused_sgd_(kp, gs, lr=0.01, weight_decay=1e-4)
    fo._plain_sgd_(ps, gs, np.float32(0.01), np.float32(1e-4), False)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kp, ps))
    want = len(fo.table_splits(n, cap))
    assert want == 2 and counters.get("fused_sgd") == want
    assert rec == {"tensors": n, "elements": sum(sizes), "launches": want}


def _lamb_state(dev, shapes, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    ps = [torch.randn(s, generator=g, device=dev) * 0.02 for s in shapes]
    ps[1].zero_()
    grads = [[torch.randn(s, generator=g, device=dev) * 0.01 for s in shapes]
             for _ in range(2)]
    return ps, grads


_LAMB_SHAPES = [(30592, 64), (768,), (3,), (0,), (1000, 7), (16384,),
                (8193,)]


def test_fused_lamb_kernels_are_bitwise_the_plain_version(dev):
    """Two steps from zero moments; a zero bias (trust 1), an empty
    tensor and tensors ending on and just past a piece boundary
    included: m, v and r bit for bit; the norms phase 1 took within
    rtol 1e-6 of f64 norms; p bit for bit the plain apply given those
    norms; one count of each kernel a step."""
    shapes = _LAMB_SHAPES
    ps, grads = _lamb_state(dev, shapes, 8)
    ms = [torch.zeros(s, device=dev) for s in shapes]
    vs = [torch.zeros(s, device=dev) for s in shapes]
    rs = [torch.empty(s, device=dev) for s in shapes]
    kp, km, kv = ([x.clone() for x in xs] for xs in (ps, ms, vs))
    kr = [torch.empty(s, device=dev) for s in shapes]
    cache = {}
    for step, gs in zip((1, 2), grads):
        fo.fused_lamb_(kp, gs, km, kv, kr, lr=1e-3, beta1=0.9, beta2=0.999,
                       eps=1e-6, weight_decay=0.01, step=step, cache=cache)
        lr, c1, c2, _ = fo.adam_scalars(1e-3, 0.9, 0.999, step)
        fo._plain_lamb_phase1_(ps, gs, ms, vs, rs, 0.9, 0.999, 1e-6, 0.01,
                               c1, c2)
        norms = fo.lamb_kernel_norms(cache)
        want = torch.stack(torch._foreach_norm([x.double()
                                                for x in ps + rs]))
        torch.testing.assert_close(norms, want.float(), rtol=1e-6, atol=0.0)
        fo._plain_lamb_apply_(ps, rs, norms, lr)
    torch.cuda.synchronize()
    for a, b in zip(kp + km + kv + kr, ps + ms + vs + rs):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(kp[1]).all()) and bool(kp[1].any())
    assert counters.get("fused_lamb_phase1") == 2
    assert counters.get("fused_lamb_apply") == 2


def test_fused_lamb_two_launches_give_the_same_bits(dev):
    """The norms are a fixed tree and a fixed-order f64 sum, no float
    atomics: the same step from the same state twice gives the same p,
    m, v, r and norms bit for bit."""
    shapes = _LAMB_SHAPES
    ps, grads = _lamb_state(dev, shapes, 9)
    outs = []
    for _ in range(2):
        t = [[x.clone() for x in ps]] + [[torch.zeros(s, device=dev)
                                          for s in shapes] for _ in range(2)]
        r = [torch.empty(s, device=dev) for s in shapes]
        cache = {}
        fo.fused_lamb_(t[0], grads[0], t[1], t[2], r, lr=1e-3, beta1=0.9,
                       beta2=0.999, eps=1e-6, weight_decay=0.01, step=1,
                       cache=cache)
        outs.append(t[0] + t[1] + t[2] + r + [fo.lamb_kernel_norms(cache)])
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_slice_kernels_raise_on_what_they_do_not_take(dev):
    q = torch.zeros((1, 64, 2, 64), device=dev)
    with pytest.raises(ValueError, match="short flash"):
        fa.flash_attention_short(q, q, q)
    q = torch.zeros((1, 128, 2, 64), device=dev)
    with pytest.raises(ValueError, match="short flash"):
        fa.flash_attention_short(q, torch.zeros((1, 256, 2, 64), device=dev),
                                 torch.zeros((1, 256, 2, 64), device=dev))
    p = torch.zeros(8, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError, match="f32"):
        fo.fused_sgd_([p], [p], lr=0.1)
    with pytest.raises(ValueError, match="f32"):
        fo.fused_lamb_([p], [p], [p], [p], [p], lr=1e-3, beta1=0.9,
                       beta2=0.999, eps=1e-6, weight_decay=0.01, step=1)
    assert counters.snapshot() == {}


# ---------------------------------------------------------------------------
# K3's static forms: one parameter a launch, scalars on the device
# ---------------------------------------------------------------------------
_STATIC_SHAPES = [(16, 3, 3, 3), (16,), (64, 10), (1,), (3000, 7)]


def _static_case(dev, op, shape, found, seed):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(scale, positive=False):
        x = torch.randn(shape, generator=g, device=dev) * scale
        return x.abs() if positive else x
    ins = {"p": rnd(0.5), "g": rnd(0.1),
           "lr": torch.tensor([0.05], device=dev)}
    if op in ("momentum", "nesterov"):
        ins["v"] = rnd(0.05)
    if op in ("adam", "lamb"):
        ins.update(m=rnd(0.01), v=rnd(1e-3, positive=True),
                   b1p=torch.tensor([0.9 ** 3], device=dev),
                   b2p=torch.tensor([0.999 ** 3], device=dev))
    ins["found"] = None if found is None else torch.tensor([found],
                                                           device=dev)
    return ins


def _static_apply(op, t, plain):
    """Run the static op on ``t`` (in place); the pows' outputs."""
    p, g, lr, found = t["p"], t["g"], t["lr"], t["found"]
    if op == "sgd":
        (fo._plain_static_sgd_ if plain else fo.static_sgd_)(p, g, lr, found)
        return ()
    if op in ("momentum", "nesterov"):
        nest = op == "nesterov"
        if plain:
            fo._plain_static_momentum_(p, g, t["v"], lr, 0.9, nest, found)
        else:
            fo.static_momentum_(p, g, t["v"], lr, mu=0.9, nesterov=nest,
                                found=found)
        return ()
    args = (p, g, t["m"], t["v"], t["b1p"], t["b2p"], lr)
    if op == "adam":
        if plain:
            return fo._plain_static_adam_(*args, 0.9, 0.999, 1e-8, found)
        return fo.static_adam_(*args, beta1=0.9, beta2=0.999, eps=1e-8,
                               found=found)
    if plain:
        return fo._plain_static_lamb_(*args, 0.9, 0.999, 1e-6, 0.01, found)
    return fo.static_lamb_(*args, beta1=0.9, beta2=0.999, eps=1e-6,
                           weight_decay=0.01, found=found)


_STATIC_COUNTERS = {"sgd": ("static_sgd",), "momentum": ("static_momentum",),
                    "nesterov": ("static_momentum",), "adam": ("static_adam",),
                    "lamb": ("static_lamb_phase1", "static_lamb_apply")}


@pytest.mark.parametrize("found", [None, False, True],
                         ids=["absent", "false", "true"])
@pytest.mark.parametrize("op", list(_STATIC_COUNTERS))
def test_static_update_kernels_are_bitwise_the_plain_version(dev, op, found):
    """Every tensor of the static example's kinds, one launch each:
    p, the moments or velocity and the beta-pow outputs bit for bit; a
    set flag keeps all of them, the pows included."""
    for k, shape in enumerate(_STATIC_SHAPES):
        kern = _static_case(dev, op, shape, found, seed=k)
        plain = {n: (None if x is None else x.clone())
                 for n, x in kern.items()}
        before = {n: (None if x is None else x.clone())
                  for n, x in kern.items()}
        kpows = _static_apply(op, kern, plain=False)
        ppows = _static_apply(op, plain, plain=True)
        torch.cuda.synchronize()
        for n in kern:
            if kern[n] is not None:
                assert torch.equal(kern[n], plain[n]), (op, shape, n)
        for a, b in zip(kpows, ppows):
            assert a.shape == (1,) and torch.equal(a, b), (op, shape)
        if found:
            for n in kern:
                if kern[n] is not None:
                    assert torch.equal(kern[n], before[n]), (op, shape, n)
            for a, old in zip(kpows, (before.get("b1p"), before.get("b2p"))):
                assert torch.equal(a, old)
        else:
            assert not torch.equal(kern["p"], before["p"])
    for name in _STATIC_COUNTERS[op]:
        assert counters.get(name) == len(_STATIC_SHAPES)
    assert counters.get("fused_momentum") == 0


def _static_run(dev, op, shapes, founds, seed):
    """A run's per-op inputs; every other tensor a view one element into
    a larger buffer, so its pointers are not 16-byte aligned and the
    kernel takes it one element at a time."""
    run = []
    for k, (shape, found) in enumerate(zip(shapes, founds)):
        t = _static_case(dev, op, shape, found, seed=seed + k)
        if k % 2:
            for n in ("p", "g", "v", "m"):
                if n in t:
                    buf = torch.empty(t[n].numel() + 1, device=dev)
                    buf[1:] = t[n].reshape(-1)
                    t[n] = buf[1:].view(shape)
        run.append(t)
    return run


def _static_run_apply(op, run, plain):
    """The list form over ``run`` (or the loop of per-op plain
    versions); each op's pow outputs."""
    def col(k):
        return [t[k] for t in run]
    p, g, lr, found = col("p"), col("g"), col("lr"), col("found")
    if op == "sgd":
        (fo._plain_static_sgd_list_ if plain else fo.static_sgd_list_)(
            p, g, lr, found)
        return [()] * len(run)
    if op in ("momentum", "nesterov"):
        nest = op == "nesterov"
        if plain:
            fo._plain_static_momentum_list_(p, g, col("v"), lr, 0.9, nest,
                                            found)
        else:
            fo.static_momentum_list_(p, g, col("v"), lr, mu=0.9,
                                     nesterov=nest, founds=found)
        return [()] * len(run)
    args = (p, g, col("m"), col("v"), col("b1p"), col("b2p"), lr)
    if op == "adam":
        if plain:
            return fo._plain_static_adam_list_(*args, 0.9, 0.999, 1e-8,
                                               found)
        return fo.static_adam_list_(*args, beta1=0.9, beta2=0.999, eps=1e-8,
                                    founds=found)
    if plain:
        return fo._plain_static_lamb_list_(*args, 0.9, 0.999, 1e-6, 0.01,
                                           found)
    return fo.static_lamb_list_(*args, beta1=0.9, beta2=0.999, eps=1e-6,
                                weight_decay=0.01, founds=found)


_STATIC_ROLES = {"static_sgd": 4, "static_momentum": 5, "static_adam": 10,
                 "static_lamb_phase1": 10, "static_lamb_apply": 6}


@pytest.mark.parametrize("found", [None, False, True, "mixed"],
                         ids=["absent", "false", "true", "mixed"])
@pytest.mark.parametrize("op", list(_STATIC_COUNTERS))
def test_static_run_is_one_launch_and_bitwise_the_plain_version(dev, op,
                                                                found):
    """A run of update ops of mixed sizes (lengths 1, 7, 13 and others
    that are not multiples of 4; aligned tensors and misaligned views)
    through the list form: one launch of each kernel for the run, and p,
    the moments or velocity and the pow outputs bit for bit the loop of
    per-op plain versions; a set flag keeps its op's state."""
    shapes = _STATIC_SHAPES + [(7,), (13, 3), (1000, 5), (2,), (4099,)]
    founds = ([None] * len(shapes) if found is None
              else [found] * len(shapes) if found != "mixed"
              else [bool(k % 3 == 0) for k in range(len(shapes))])
    kern = _static_run(dev, op, shapes, founds, seed=40)
    plain = [{n: (None if x is None else x.clone()) for n, x in t.items()}
             for t in kern]
    before = [{n: (None if x is None else x.clone()) for n, x in t.items()}
              for t in kern]
    kpows = _static_run_apply(op, kern, plain=False)
    ppows = _static_run_apply(op, plain, plain=True)
    torch.cuda.synchronize()
    for t, u, b, kp, pp in zip(kern, plain, before, kpows, ppows):
        for n in t:
            if t[n] is not None:
                assert torch.equal(t[n], u[n]), (op, n)
        for a, c in zip(kp, pp):
            assert a.shape == (1,) and torch.equal(a, c), op
        if t["found"] is not None and bool(t["found"]):
            assert torch.equal(t["p"], b["p"]), op
        else:
            assert not torch.equal(t["p"], b["p"]), op
    for name in _STATIC_COUNTERS[op]:
        assert counters.get(name) == 1, (name, counters.snapshot())


@pytest.mark.parametrize("op", ["sgd", "adam", "lamb"])
def test_static_run_splits_at_the_table_capacity(dev, op):
    """A run of exactly ``static_capacity`` tensors is one launch (the
    build's kernel parameter space holds its table: 32,764 bytes from
    CUDA 12.1 on), one more tensor makes two, in op order, and both stay
    bit for bit the plain loop."""
    roles = {"sgd": 4, "adam": 10, "lamb": 10}[op]
    cap = fo.static_capacity(roles)
    assert cap == (((fo.static_param_bytes() - 128) // 8) - 1) // \
        (roles + 1)
    for n in (cap, cap + 1):
        counters.reset()
        shapes = [(3 + k % 5,) for k in range(n)]
        kern = _static_run(dev, op, shapes, [None] * n, seed=7)
        plain = [{k: (None if x is None else x.clone())
                  for k, x in t.items()} for t in kern]
        kpows = _static_run_apply(op, kern, plain=False)
        ppows = _static_run_apply(op, plain, plain=True)
        torch.cuda.synchronize()
        for t, u in zip(kern, plain):
            assert all(torch.equal(t[k], u[k]) for k in t
                       if t[k] is not None)
        for kp, pp in zip(kpows, ppows):
            assert all(torch.equal(a, b) for a, b in zip(kp, pp))
        for name in _STATIC_COUNTERS[op]:
            want = -(-n // fo.static_capacity(_STATIC_ROLES[name]))
            assert counters.get(name) == want, (n, name)


def test_static_update_kernels_raise_on_what_they_do_not_take(dev):
    p = torch.zeros(8, device=dev)
    lr = torch.ones(1, device=dev)
    with pytest.raises(ValueError, match="f32"):
        fo.static_sgd_(p.double(), p.double(), lr)
    with pytest.raises(ValueError, match="lr"):
        fo.static_sgd_(p, p, lr.cpu())
    with pytest.raises(ValueError, match="FoundInfinite"):
        fo.static_sgd_(p, p, lr, found=torch.zeros(1, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        fo.static_momentum_(torch.zeros(4, 4, device=dev).t(),
                            torch.zeros(4, 4, device=dev),
                            torch.zeros(4, 4, device=dev), lr, mu=0.9)
    assert counters.snapshot() == {}


# ---------------------------------------------------------------------------
# slice 7: the embedding bag and the masked flash kernels
# ---------------------------------------------------------------------------
from paddle_tpu_torch.ops.cuda import fused_embedding as fe  # noqa: E402


def _bf16_ulp(x):
    """One bf16 ulp at each element's magnitude (8 significant bits)."""
    _, e = torch.frexp(x.abs())
    return torch.where(x == 0, torch.full_like(x, 2.0 ** -133),
                       torch.ldexp(torch.ones_like(x), e - 8))


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("V,D,B,S,id_dtype,offset", [
    (1000, 256, 64, 64, torch.int64, 0),
    (50, 20, 7, 3, torch.int32, 0),
    (300, 1200, 5, 1500, torch.int64, 0),
    (40, 64, 9, 17, torch.int32, 1),
], ids=["ctr", "D20-int32", "two-chunks", "unaligned"])
def test_embedding_bag_kernel_matches_plain(dev, combiner, dtype, V, D, B,
                                            S, id_dtype, offset):
    """Ids in [-V/4, 5V/4): negatives are padding, ids >= V read row V - 1;
    bag 0 is all padding. D = 20 and an unaligned table run the scalar
    form; S = 1500 takes two id chunks and D = 1200 two column chunks.
    f32: the kernel and the plain version sum in other orders, so each
    element agrees within 1e-5 plus the worst-case error of a recursive
    f32 sum, S * 2**-24 times its bag's sum of |rows| (a 1500-id bag
    whose ids >= V all read one row drifts by ~3e-3); bf16: within one
    ulp."""
    g = torch.Generator(device=dev).manual_seed(21)
    flat = torch.randn(V * D + offset, generator=g, device=dev).to(dtype)
    table = flat[offset:].view(V, D)
    ids = torch.randint(-(V // 4), V + V // 4, (B, S), generator=g,
                        device=dev, dtype=id_dtype)
    ids[0] = -1
    out = fe.bag_forward(table, ids, combiner)
    ref = fe._plain_bag(table, ids, combiner)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (B, D)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    if dtype == torch.float32:
        mag = fe._plain_bag(table.abs(), ids, combiner)
        err = (out - ref).abs()
        assert bool((err <= 1e-5 + S * 2.0 ** -24 * mag).all()), \
            float(err.max())
    else:
        err = (out.float() - ref.float()).abs()
        assert bool((err <= _bf16_ulp(ref.float())).all()), float(err.max())
    assert counters.get("fused_embedding_bag") == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("V,D,B,S", [(100000, 256, 4096, 64),
                                     (24000, 256, 4096, 64),
                                     (100000, 256, 200000, 4),
                                     (100000, 100, 512, 64),
                                     (100000, 256, 64, 1500),
                                     (100000, 256, 1200, 1500)],
                         ids=["over_l2", "fits_l2", "many_waves", "D100",
                              "long_bags", "long_bags_swept"])
def test_embedding_bag_sweep_matches_plain(dev, dtype, V, D, B, S):
    """Both forms of the kernel. On an H100 (132 SMs, 50 MB of L2) the f32
    tables of 100000 x 256 take the row-order sweep: 4096 bags, 200,000
    bags of 4 ids (more CTAs than the card holds at once: at least 4
    waves) and 1200 bags of 1500 ids (three staged runs, each sorted on
    its own); the per-bag form takes the 24,000-row table (less than half
    the L2), D = 100 (400-byte rows, the float4 form), 64 bags of 1500 ids
    (too few to fill the card) and every bf16 table (512-byte rows). The
    plain version within atol 1e-5 + rtol 1e-5 (f32, another sum
    order; for 1500-id bags 1e-5 plus the worst-case error of a
    recursive f32 sum, S * 2**-24 times the bag's sum of |rows|) or one
    bf16 ulp; two launches bit for bit; one count a launch."""
    g = torch.Generator(device=dev).manual_seed(23)
    table = torch.randn((V, D), generator=g, device=dev).to(dtype)
    ids = torch.randint(-(V // 5), V + 40, (B, S), generator=g, device=dev)
    for combiner in ("sum", "mean", "sqrtn"):
        out = fe._cuda_bag(table, ids, combiner)
        again = fe._cuda_bag(table, ids, combiner)
        ref = fe._plain_bag(table, ids, combiner)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        err = (out.float() - ref.float()).abs()
        if dtype == torch.float32:
            tol = 1e-5 + 1e-5 * ref.abs()
            if S > 64:
                mag = fe._plain_bag(table.abs(), ids, combiner)
                tol = 1e-5 + S * 2.0 ** -24 * mag
            assert bool((err <= tol).all()), float(err.max())
        else:
            assert bool((err <= _bf16_ulp(ref.float())).all()), \
                float(err.max())
    assert counters.get("fused_embedding_bag") == 6


def test_embedding_bag_gradient_on_the_card_matches_the_cpu(dev):
    """The table's gradient of one seeded upstream gradient, card against
    CPU: the backward alone. The forward, whose f32 sum order differs
    between the two, is held to its own bound above; an upstream gradient
    made from the forward's output, such as that of (out * out).sum(),
    would carry that difference into the gradient (the forward's bound
    times 2 |out| times each row's reuse), past this test's 1e-5."""
    g = torch.Generator().manual_seed(22)
    table = torch.randn((500, 128), generator=g)
    ids = torch.randint(-50, 550, (32, 40), generator=g)
    gout = torch.randn((32, 128), generator=g)
    for combiner in ("sum", "mean", "sqrtn"):
        grads = []
        for d in ("cpu", dev):
            t = table.clone().to(d).requires_grad_()
            out = fe.fused_embedding_bag(t, ids.to(d), combiner)
            out.backward(gout.to(d))
            grads.append(t.grad.cpu())
        torch.testing.assert_close(grads[1], grads[0], atol=1e-5, rtol=1e-5)
    assert counters.get("fused_embedding_bag") == 3


def _key_mask(dev, B, L, kind, lens):
    col = torch.arange(L, device=dev)
    if kind == "first_tile":
        return (col >= 64).expand(B, L).contiguous()
    return col < torch.tensor(lens, device=dev).view(B, 1)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,L,H,D,causal,p,kind,lens", [
    (2, 128, 12, 64, False, 0.0, "lens", (128, 77)),
    (2, 256, 4, 64, False, 0.1, "lens", (256, 0)),
    (3, 200, 3, 64, True, 0.1, "lens", (200, 65, 130)),
    (2, 192, 2, 128, False, 0.0, "lens", (192, 100)),
    (2, 256, 2, 64, False, 0.1, "first_tile", None),
], ids=["bert", "all-masked-dropout", "ragged-causal", "D128",
        "first-tile-masked"])
def test_masked_flash_kernels_match_plain(dev, dtype, atol, B, L, H, D,
                                          causal, p, kind, lens):
    q, k, v, do = _qkvo(dev, 13, B, L, H, D, dtype)
    bias = fa.kv_mask_bias(_key_mask(dev, B, L, kind, lens), B, L)
    out, lse = fa.flash_attention_fwd(q, k, v, causal, p, 99, bias)
    rout, rlse = fa._plain_fwd(q, k, v, causal, p, 99, bias)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, p, 99,
                                   bias)
    rgrads = fa._plain_bwd(q, k, v, rout, rlse, do, causal, p, 99, bias)
    torch.cuda.synchronize()
    for t in (out,) + tuple(grads):
        assert bool(torch.isfinite(t.float()).all())
    torch.testing.assert_close(out.float(), rout.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-4, rtol=0)
    for got, want in zip(grads, rgrads):
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=atol)
    if lens is not None and 0 in lens and p == 0.0:
        b = lens.index(0)
        torch.testing.assert_close(
            out[b].float(), v[b].float().mean(0, keepdim=True).expand(
                L, H, D), atol=atol, rtol=0)
    assert counters.get("flash_attention_masked_fwd") == 1
    assert counters.get("flash_attention_masked_bwd") == 1
    assert counters.get("flash_attention_fwd") == 0
    assert counters.get("flash_attention_bwd") == 0


def test_masked_flash_all_masked_batch_is_the_mean_of_v(dev):
    q, k, v, _ = _qkvo(dev, 14, 2, 256, 2, 64, torch.float32)
    bias = fa.kv_mask_bias(_key_mask(dev, 2, 256, "lens", (256, 0)), 2, 256)
    out = fa.flash_attention(q, k, v, bias=bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[1], v[1].mean(0, keepdim=True).expand(
        256, 2, 64), atol=1e-5, rtol=0)


def test_slice7_kernels_raise_on_what_they_do_not_take(dev):
    q = torch.zeros((2, 128, 2, 64), device=dev)
    with pytest.raises(ValueError, match="key mask"):
        fa.flash_attention(q, q, q, bias=torch.zeros((2, 128), device=dev,
                                                     dtype=torch.float64))
    with pytest.raises(ValueError, match="key mask"):
        fa.flash_attention(q, q, q, bias=torch.zeros((2, 127), device=dev))
    with pytest.raises(ValueError, match="key mask"):
        fa.flash_attention(q, q, q, bias=torch.zeros((2, 128)))
    with pytest.raises(ValueError, match="no key mask"):
        fa.flash_attention_short(q, q, q,
                                 bias=torch.zeros((2, 128), device=dev))
    ids = torch.zeros((2, 3), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError, match="f32 or bf16"):
        fe.fused_embedding_bag(torch.zeros((4, 8), device=dev,
                                           dtype=torch.float64), ids)
    with pytest.raises(TypeError, match="int32 or int64"):
        fe.fused_embedding_bag(torch.zeros((4, 8), device=dev),
                               ids.to(torch.int16))
    with pytest.raises(ValueError, match="one device"):
        fe.fused_embedding_bag(torch.zeros((4, 8), device=dev), ids.cpu())
    assert counters.snapshot() == {}


# ---------------------------------------------------------------------------
# slice 11a: K1's external-lse backward and a sequence-parallel step
# ---------------------------------------------------------------------------
def _global_stats(q, k, v, do, k0, v0, bias):
    """lse and delta of q over the keys (k0, k) from the plain forward:
    the whole sequence's statistics, k/v being its second block."""
    B, L, H, _ = q.shape
    bias0 = None if bias is None else torch.cat([torch.zeros_like(bias),
                                                 bias], 1)
    out, lse = fa._plain_fwd(q, torch.cat([k0, k], 1), torch.cat([v0, v], 1),
                             False, 0.0, 0, bias0)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1)
    return lse, delta.reshape(B * H, L).contiguous()


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,L,H,D,causal,masked", [
    (2, 128, 12, 64, False, False),
    (2, 200, 3, 64, True, False),
    (2, 192, 2, 128, False, True),
    (3, 256, 2, 64, True, True),
], ids=["full", "ragged-causal", "D128-masked", "causal-masked"])
def test_ext_backward_kernel_matches_plain(dev, dtype, atol, B, L, H, D,
                                           causal, masked):
    q, k, v, do = _qkvo(dev, 21, B, L, H, D, dtype)
    _, k0, v0, _ = _qkvo(dev, 22, B, L, H, D, dtype)
    bias = fa.kv_mask_bias(_key_mask(dev, B, L, "lens", [L] + [L // 3]
                                     * (B - 1)), B, L) if masked else None
    lse, delta = _global_stats(q, k, v, do, k0, v0, bias)
    got = fa.flash_attention_bwd_ext(q, k, v, do, lse, delta, causal, bias)
    want = fa._plain_bwd_ext(q, k, v, do, lse, delta, causal, bias)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == dtype and bool(torch.isfinite(a.float()).all())
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=atol)
    assert counters.snapshot() == {"flash_attention_ext_bwd": 1}


def test_ext_backward_kernel_raises_on_what_it_does_not_take(dev):
    q = torch.zeros((2, 128, 2, 64), device=dev)
    lse = torch.zeros((4, 128), device=dev)
    with pytest.raises(ValueError, match="lse must be"):
        fa.flash_attention_bwd_ext(q, q, q, q, lse[:, :64], lse)
    with pytest.raises(ValueError, match="delta must be"):
        fa.flash_attention_bwd_ext(q, q, q, q, lse, lse.double())
    with pytest.raises(ValueError, match="delta must be"):
        fa.flash_attention_bwd_ext(q, q, q, q, lse, lse.cpu())
    with pytest.raises(ValueError, match="dout"):
        fa.flash_attention_bwd_ext(q, q, q, q.bfloat16(), lse, lse)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention_bwd_ext(q, q[:, :64].contiguous(),
                                   q[:, :64].contiguous(), q, lse, lse, True)
    assert counters.snapshot() == {}


def test_sp_step_two_ranks_on_one_card_matches_one_process(dev, tmp_path):
    """Two gloo ranks on cuda:0 over {"sp": 2}, two AdamW steps of a small
    GPT (head_dim 64), against the same steps in this process: losses
    and step-1 gradients (atol 1e-4 + rtol 1e-4); the ranks launch one K1a
    and one external-lse K1b per live block and no saved-form K1b."""
    import _torch_sp_ranks as ranks
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=2, max_position_embeddings=128,
                    hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    gen = torch.Generator().manual_seed(0)
    state = {k: v.numpy() for k, v in GPTForCausalLM(
        cfg, device="cpu", generator=gen).state_dict().items()}
    ids = np.random.RandomState(0).randint(0, 256, (2, 128)).astype(np.int64)
    sp = spawn(ranks.gpt_sp_rank,
               args=({"sp": 2}, cfg, state, ids, 2, 1e-3, "cuda"), nprocs=2,
               init_method=f"file://{tmp_path / 'rendezvous'}", timeout=300)
    model = ranks._gpt(cfg, state, "cuda")
    step = TrainStep(model, lambda m, x: m.loss(x),
                     AdamW(learning_rate=1e-3, parameters=model.parameters(),
                           weight_decay=0.01))
    batch = torch.tensor(ids, device=dev)
    losses = [float(step(batch))]
    grads = {n: p.grad.float().cpu().numpy()
             for n, p in model.named_parameters()}
    losses.append(float(step(batch)))
    for r, got in enumerate(sp):
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-4,
                                   atol=1e-4)
        for n, g in grads.items():
            np.testing.assert_allclose(got["grads"][n], g, rtol=1e-4,
                                       atol=1e-4, err_msg=f"rank {r} {n}")
        want = {"flash_attention_fwd": 2 * 2 * (r + 1),
                "flash_attention_ext_bwd": 2 * 2 * (r + 1),
                "fused_adam": 2}
        assert {k: got["launches"].get(k, 0) for k in want} == want
        assert "flash_attention_bwd" not in got["launches"]
        assert got["launches"]["gloo_staged_bytes"] > 0
        assert got["dropout_raises"]


def test_masked_ring_two_ranks_on_one_card_matches_the_kernel(dev, tmp_path):
    """``ring_attention`` over two gloo ranks on cuda:0, causal with a key
    mask whose second block is dead on every row (skipped by both
    ranks), and full: output and gradients against the one-launch
    kernels in this process, f32 atol 1e-4 (the merge and the per-block
    sums run in another order)."""
    import _torch_sp_ranks as ranks
    from paddle_tpu_torch.distributed import spawn

    rng = np.random.RandomState(5)
    B, L, H, D = 2, 256, 2, 64
    cases = [(name, *(rng.randn(B, L, H, D).astype(np.float32)
                      for _ in range(4)), causal, lens)
             for name, causal, lens in (("padded_causal", True, [100, 60]),
                                        ("full", False, None))]
    got = spawn(ranks.ring_rank, args=(2, cases, "cuda"), nprocs=2,
                init_method=f"file://{tmp_path / 'rendezvous'}",
                timeout=300)
    for name, q, k, v, w, causal, lens in cases:
        q, k, v = (torch.tensor(x, device=dev, requires_grad=True)
                   for x in (q, k, v))
        bias = None if lens is None else fa.kv_mask_bias(
            _key_mask(dev, B, L, "lens", lens), B, L)
        out = fa.flash_attention(q, k, v, causal=causal, bias=bias)
        (out * torch.tensor(w, device=dev)).sum().backward()
        for r in range(2):
            for a, b in zip(got[r][name], (out, q.grad, k.grad, v.grad)):
                np.testing.assert_allclose(a, b.detach().cpu().numpy(),
                                           atol=1e-4, rtol=0)
    for r in range(2):
        # padded_causal: rank 0 its diagonal, rank 1 block 0 (its own block
        # is dead); full: both blocks on each rank
        launches = got[r]["launches"]
        assert {k: launches.get(k, 0) for k in (
            "flash_attention_masked_fwd", "flash_attention_fwd",
            "flash_attention_ext_bwd", "flash_attention_bwd")} == {
            "flash_attention_masked_fwd": 1, "flash_attention_fwd": 2,
            "flash_attention_ext_bwd": 3, "flash_attention_bwd": 0}
        assert launches["gloo_staged_bytes"] > 0


# ---------------------------------------------------------------------------
# K3's ZeRO chunk entry (chunk Lamb)
# ---------------------------------------------------------------------------
_CHUNK_LAYOUTS = [((700, 1500, 300, 1000), 2048, 0),
                  ((700, 1500, 300, 1000), 2048, 2048),
                  ((2048, 1500), 2048, 2048),
                  ((64,) * 40 + (9000,), 6144, 0),
                  ((30522 * 768,), 11720704, 11720704)]


def _chunk_case(dev, layout, found, seed):
    elems, c, pos = layout
    rng = np.random.RandomState(seed)
    t = {"p": rng.randn(c).astype(np.float32) * np.float32(0.5),
         "g": rng.randn(c).astype(np.float32) * np.float32(0.1),
         "m": rng.randn(c).astype(np.float32) * np.float32(0.01),
         "v": np.abs(rng.randn(c)).astype(np.float32) * np.float32(1e-3)}
    tail = min(c, max(0, pos + c - sum(elems)))
    if tail:
        for x in t.values():
            x[c - tail:] = 0.0
    t = {k: torch.tensor(x, device=dev) for k, x in t.items()}
    t["b1p"] = torch.tensor([0.9 ** 3], device=dev)
    t["b2p"] = torch.tensor([0.999 ** 3], device=dev)
    t["lr"] = torch.tensor([0.05], device=dev)
    t["found"] = None if found is None else torch.tensor([found],
                                                          device=dev)
    return t


@pytest.mark.parametrize("found", [None, False, True],
                         ids=["absent", "false", "true"])
@pytest.mark.parametrize("layout", range(len(_CHUNK_LAYOUTS)))
def test_chunk_lamb_kernels_match_the_plain_version(dev, layout, found):
    """m, v and the beta-pow outputs bit for bit, p within 1e-6 of the
    largest |p| (the norms sum by pieces, the plain version by
    index_add_); two launches give the same bits; one launch of each
    kernel a call."""
    from paddle_tpu_torch.ops.cuda import fused_optimizer as fo

    lay = _CHUNK_LAYOUTS[layout]
    elems, c, pos = lay
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01)
    outs = []
    for _ in range(2):
        t = _chunk_case(dev, lay, found, seed=layout)
        pows = fo.chunk_lamb_(t["p"], t["g"], t["m"], t["v"], t["b1p"],
                              t["b2p"], t["lr"], param_elems=elems,
                              position=pos, found=t["found"], **kw)
        outs.append((t, pows))
    pl = _chunk_case(dev, lay, found, seed=layout)
    seg = torch.from_numpy(fo.chunk_segments(elems, pos, c)).to(dev)
    ppows = fo._plain_chunk_lamb_(pl["p"], pl["g"], pl["m"], pl["v"],
                                  pl["b1p"], pl["b2p"], pl["lr"], 0.9,
                                  0.999, 1e-6, 0.01, pl["found"], seg,
                                  len(elems) + 1, lambda s: None)
    torch.cuda.synchronize()
    (t, pows), (t2, _) = outs
    assert torch.equal(t["p"], t2["p"])
    for k in ("m", "v"):
        assert torch.equal(t[k], pl[k]), k
    for a, b in zip(pows, ppows):
        assert a.shape == (1,) and torch.equal(a, b.reshape(1))
    scale = float(pl["p"].abs().max())
    assert float((t["p"] - pl["p"]).abs().max()) <= 1e-6 * scale
    if found:
        assert torch.equal(t["p"], _chunk_case(dev, lay, found, layout)["p"])
    assert counters.get("chunk_lamb_phase1") == 2
    assert counters.get("chunk_lamb_apply") == 2


def test_chunk_lamb_is_two_launches_and_leaves_the_ticket_at_zero(dev):
    """A call is one phase-1 launch (the segment sums folded in by the
    last block's ticket) and one apply launch; calls on a shared cache
    leave the ticket at 0 and give the bits of calls on fresh caches; a
    set flag keeps p, m and v."""
    from paddle_tpu_torch.ops.cuda import fused_optimizer as fo

    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01)
    for lay in (_CHUNK_LAYOUTS[0], _CHUNK_LAYOUTS[3]):
        elems, c, pos = lay
        cache = {}
        for found in (None, False, True):
            runs = []
            for shared in (cache, {}):
                t = _chunk_case(dev, lay, found, seed=c)
                n0 = counters.snapshot()
                fo.chunk_lamb_(t["p"], t["g"], t["m"], t["v"], t["b1p"],
                               t["b2p"], t["lr"], param_elems=elems,
                               position=pos, found=t["found"], cache=shared,
                               **kw)
                n1 = counters.snapshot()
                assert n1.get("chunk_lamb_phase1", 0) == \
                    n0.get("chunk_lamb_phase1", 0) + 1
                assert n1.get("chunk_lamb_apply", 0) == \
                    n0.get("chunk_lamb_apply", 0) + 1
                runs.append(t)
            torch.cuda.synchronize()
            assert int(cache["ticket"].item()) == 0
            for k in ("p", "m", "v"):
                assert torch.equal(runs[0][k], runs[1][k]), k
            if found:
                before = _chunk_case(dev, lay, found, seed=c)
                for k in ("p", "m", "v"):
                    assert torch.equal(runs[0][k], before[k]), k


def test_chunk_lamb_raises_on_what_it_does_not_take(dev):
    from paddle_tpu_torch.ops.cuda import fused_optimizer as fo

    p = torch.zeros(1024, device=dev)
    one = torch.ones(1, device=dev)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.0,
              param_elems=(1024,), position=0)
    with pytest.raises(ValueError, match="f32"):
        fo.chunk_lamb_(p, p.half(), p, p, one, one, one, **kw)
    with pytest.raises(ValueError, match="FoundInfinite"):
        fo.chunk_lamb_(p, p, p, p, one, one, one,
                       found=torch.zeros(1, device=dev), **kw)
    with pytest.raises(ValueError, match="on cuda"):
        fo.chunk_lamb_(p, p.cpu(), p, p, one, one, one, **kw)
    assert counters.snapshot() == {}


def test_zero_step_two_ranks_on_one_card(dev, tmp_path):
    """The book conv net over {"dp": 2} on cuda:0 (gloo): comm f32 x 2,
    ZeRO-2 f32 x 2, comm f32 x 2 bit for bit six comm f32 steps
    (Momentum); ZeRO-2 Lamb within rtol 1e-5 + atol 1e-6 of comm Lamb;
    one chunk_lamb_phase1 and one chunk_lamb_apply a bucket and step on
    each rank, and no static Lamb launch in the ZeRO steps."""
    import _torch_zero_ranks as ranks
    import paddle_tpu_torch.static as ts
    from paddle_tpu_torch.distributed import spawn
    from paddle_tpu_torch.utils import unique_name as tun

    torch.backends.cudnn.deterministic = True
    feed = {"img": np.random.RandomState(5).rand(64, 1, 28, 28).astype(
        np.float32),
        "label": np.random.RandomState(6).randint(0, 10, (64, 1))}
    cases = []
    for opt in ("momentum", "lamb"):
        _m, startup, _l, _e = ranks.book_net(ts, tun, opt)
        scope = ts.Scope()
        with ts.scope_guard(scope):
            ts.Executor(ts.CPUPlace()).run(startup)
        init = {k: v.numpy() for k, v in scope.items()}
        f32, z2 = {"comm_quant": "f32"}, {"comm_quant": "f32",
                                          "zero_stage": 2}
        cases += [(f"{opt}_comm", "book_net", opt, init, feed, [f32] * 3, 2,
                   False),
                  (f"{opt}_mix", "book_net", opt, init, feed,
                   [f32, z2, f32] if opt == "momentum" else [z2] * 3, 2,
                   False)]
    got = spawn(ranks.zero_rank, args=(2, cases, "cuda"), nprocs=2,
                init_method=f"file://{tmp_path / 'rendezvous'}",
                timeout=300)
    for r in got:
        for c in cases:
            assert "error" not in r[c[0]], r[c[0]]
        assert r["momentum_mix"]["losses"] == r["momentum_comm"]["losses"]
        np.testing.assert_allclose(r["lamb_mix"]["losses"],
                                   r["lamb_comm"]["losses"], rtol=1e-5,
                                   atol=1e-6)
        la = r["lamb_mix"]["launches"]
        assert la.get("chunk_lamb_phase1") == 6
        assert la.get("chunk_lamb_apply") == 6
        assert la.get("static_lamb_phase1", 0) == 0
        assert la.get("zero.zero") == 1 and "zero.xla" not in la
        # the 6 update ops of a comm step are one run (one launch) x 4
        # comm steps, + 2 chunk steps
        assert r["momentum_mix"]["launches"].get("static_momentum") \
            == 4 * 1 + 2 * 1


# ---------------------------------------------------------------------------
# the tensor-core forms: K1c's forward and K1b (plain, masked and
# external-lse) in bf16 at the main paths' shapes, held to chip_smoke's
# bf16 tolerance (atol 2e-2 + rtol 1e-2; lse within 1e-4); their
# determinism; the f32 forms (the FMA kernels) at the parity tolerance
# ---------------------------------------------------------------------------
def _close_bf16(got, want, what):
    err = (got.float() - want.float()).abs().max().item()
    assert bool(torch.isfinite(got.float()).all()), what
    assert torch.allclose(got.float(), want.float(), atol=2e-2, rtol=1e-2), \
        f"{what}: max abs err {err}"


def _padded_bias(dev, B, L, seed=0):
    """A key-padding bias of lengths in [L/4, L], row 0 full."""
    lens = np.random.RandomState(seed).randint(L // 4, L + 1, B)
    lens[0] = L
    return fa.kv_mask_bias(_key_mask(dev, B, L, "lens", lens.tolist()), B, L)


@pytest.mark.parametrize("B,L,H,D,causal,p", [
    (32, 512, 12, 64, False, 0.1),
    (4, 512, 8, 128, False, 0.1),
    (4, 256, 12, 64, True, 0.1),
], ids=["bert512-dropout", "D128", "causal"])
def test_tensor_core_short_forward_matches_plain(dev, B, L, H, D, causal, p):
    q, k, v, _ = _qkvo(dev, 31, B, L, H, D, torch.bfloat16)
    out, lse = fa.flash_attention_short_fwd(q, k, v, causal, p, 555)
    rout, rlse = fa._plain_fwd(q, k, v, causal, p, 555)
    torch.cuda.synchronize()
    _close_bf16(out, rout, "out")
    assert (lse - rlse).abs().max().item() <= 1e-4
    assert counters.snapshot() == {"flash_attention_short_fwd": 1}


@pytest.mark.parametrize("B,L,H,D,causal,p,masked", [
    (128, 128, 12, 64, False, 0.1, False),
    (8, 1024, 12, 64, True, 0.0, False),
    (32, 512, 12, 64, False, 0.1, True),
    (2, 200, 3, 128, True, 0.1, True),
], ids=["bert128-dropout", "gpt-causal", "padded512-dropout",
        "ragged-causal-D128"])
def test_tensor_core_backward_matches_plain(dev, B, L, H, D, causal, p,
                                            masked):
    q, k, v, do = _qkvo(dev, 32, B, L, H, D, torch.bfloat16)
    bias = _padded_bias(dev, B, L) if masked else None
    out, lse = fa._plain_fwd(q, k, v, causal, p, 556, bias)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, p, 556, bias)
    want = fa._plain_bwd(q, k, v, out, lse, do, causal, p, 556, bias)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close_bf16(a, b, name)
    assert counters.snapshot() == {
        "flash_attention_masked_bwd" if masked else "flash_attention_bwd": 1}


@pytest.mark.parametrize("B,Lq,Lk,H,D,causal,p,masked", [
    (128, 128, 128, 12, 64, False, 0.1, False),
    (4, 200, 333, 4, 64, False, 0.1, False),
    (8, 1024, 1024, 12, 64, True, 0.0, False),
    (32, 512, 512, 12, 64, False, 0.1, True),
    (2, 200, 200, 3, 128, True, 0.1, True),
], ids=["bert128-dropout", "Lq-ne-Lk", "gpt-causal", "padded512-dropout",
        "ragged-causal-D128"])
def test_tensor_core_forward_matches_plain(dev, B, Lq, Lk, H, D, causal, p,
                                           masked):
    """K1a's bf16 forward (``flash_fwd_mma``; a key-padded batch skips its
    dead kv tiles) against the plain version, the same bits from a second
    launch, one count a call."""
    g = torch.Generator(device=dev).manual_seed(39)
    q, k, v = [torch.randn((B, n, H, D), generator=g, device=dev)
               .to(torch.bfloat16) for n in (Lq, Lk, Lk)]
    bias = _padded_bias(dev, B, Lk) if masked else None
    first = fa.flash_attention_fwd(q, k, v, causal, p, 560, bias)
    second = fa.flash_attention_fwd(q, k, v, causal, p, 560, bias)
    rout, rlse = fa._plain_fwd(q, k, v, causal, p, 560, bias)
    torch.cuda.synchronize()
    _close_bf16(first[0], rout, "out")
    assert (first[1] - rlse).abs().max().item() <= 1e-4
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert counters.snapshot() == {
        "flash_attention_masked_fwd" if masked else "flash_attention_fwd": 2}


@pytest.mark.parametrize("causal,starts,ends", [
    (False, [0, 0, 0, 0], [256, 0, 70, 0]),
    (True, [0, 100, 3, 200], [256, 256, 256, 256]),
], ids=["no-live-key", "causal-left-padded"])
def test_tensor_core_forward_keeps_the_masked_edge_rows(dev, causal, starts,
                                                        ends):
    """Entries that must not skip dead tiles: no live key (the mean of V)
    and a causal entry whose rows before its first live key average V
    over their allowed keys; as the plain version."""
    q, k, v, _ = _qkvo(dev, 40, 4, 256, 4, 64, torch.bfloat16)
    col = torch.arange(256, device=dev)[None, :]
    keys = (col >= torch.tensor(starts, device=dev)[:, None]) \
        & (col < torch.tensor(ends, device=dev)[:, None])
    bias = fa.kv_mask_bias(keys, 4, 256)
    out, lse = fa.flash_attention_fwd(q, k, v, causal, 0.0, 561, bias)
    rout, rlse = fa._plain_fwd(q, k, v, causal, 0.0, 561, bias)
    torch.cuda.synchronize()
    _close_bf16(out, rout, "out")
    assert (lse - rlse).abs().max().item() <= 1e-4
    if not causal:
        _close_bf16(out[1], v[1].float().mean(0, keepdim=True)
                    .expand(256, 4, 64), "mean of V")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "diagonal"])
def test_tensor_core_ext_backward_matches_plain(dev, causal):
    """The SP block, 8 x 512 x 12 x 64, with the lse and delta of the
    whole two-block sequence."""
    q, k, v, do = _qkvo(dev, 33, 8, 512, 12, 64, torch.bfloat16)
    _, k0, v0, _ = _qkvo(dev, 34, 8, 512, 12, 64, torch.bfloat16)
    lse, delta = _global_stats(q, k, v, do, k0, v0, None)
    got = fa.flash_attention_bwd_ext(q, k, v, do, lse, delta, causal)
    want = fa._plain_bwd_ext(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close_bf16(a, b, name)
    assert counters.snapshot() == {"flash_attention_ext_bwd": 1}


@pytest.mark.parametrize("form", ["short_fwd", "bwd", "masked_bwd",
                                  "ext_bwd", "short_bwd"])
def test_tensor_core_kernels_are_deterministic(dev, form):
    """Two launches on the same inputs give the same bits (no atomics, no
    split across blocks)."""
    q, k, v, do = _qkvo(dev, 35, 4, 512, 12, 64, torch.bfloat16)
    bias = _padded_bias(dev, 4, 512, seed=3)
    out, lse = fa._plain_fwd(q, k, v, False, 0.1, 557)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(4 * 12, 512).contiguous()
    run = {"short_fwd": lambda: fa.flash_attention_short_fwd(
               q, k, v, False, 0.1, 557),
           "bwd": lambda: fa.flash_attention_bwd(
               q, k, v, out, lse, do, True, 0.1, 557),
           "masked_bwd": lambda: fa.flash_attention_bwd(
               q, k, v, out, lse, do, False, 0.1, 557, bias),
           "ext_bwd": lambda: fa.flash_attention_bwd_ext(
               q, k, v, do, lse, delta, False),
           "short_bwd": lambda: fa.flash_attention_short_bwd(
               q, k, v, out, lse, do, False, 0.1, 557)}[form]
    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,L,H,D,causal,p", [
    (32, 512, 12, 64, False, 0.1),
    (8, 128, 12, 64, False, 0.0),
    (4, 256, 4, 64, True, 0.1),
    (2, 384, 4, 128, False, 0.1),
], ids=["bert512-dropout", "L128", "causal", "D128-L384"])
def test_tensor_core_short_backward_is_one_deterministic_launch(dev, B, L, H,
                                                               D, causal, p):
    """K1d on tensor cores (one cluster of L / 64 CTAs a head, dQ summed
    through distributed shared memory): against the plain version at
    chip_smoke's bf16 tolerance, the same bits from a second launch, one
    ``flash_attention_short_bwd`` count a call."""
    q, k, v, do = _qkvo(dev, 38, B, L, H, D, torch.bfloat16)
    out, lse = fa._plain_fwd(q, k, v, causal, p, 559)
    first = fa.flash_attention_short_bwd(q, k, v, out, lse, do, causal, p,
                                         559)
    assert counters.snapshot() == {"flash_attention_short_bwd": 1}
    second = fa.flash_attention_short_bwd(q, k, v, out, lse, do, causal, p,
                                          559)
    want = fa._plain_bwd(q, k, v, out, lse, do, causal, p, 559)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("dq", "dk", "dv"), first, second, want):
        _close_bf16(a, c, name)
        assert torch.equal(a, b), name
    assert counters.snapshot() == {"flash_attention_short_bwd": 2}


def test_f32_forms_keep_the_parity_tolerance(dev):
    """The f32 instantiations stay the FMA kernels: K1c's forward, K1b
    with a mask and dropout, and the external-lse K1b within atol 1e-4
    of the plain versions."""
    tol = dict(atol=1e-4, rtol=0.0)
    q, k, v, do = _qkvo(dev, 36, 2, 256, 4, 64, torch.float32)
    out, lse = fa.flash_attention_short_fwd(q, k, v, True, 0.1, 558)
    rout, rlse = fa._plain_fwd(q, k, v, True, 0.1, 558)
    torch.testing.assert_close(out, rout, **tol)
    torch.testing.assert_close(lse, rlse, **tol)
    bias = _padded_bias(dev, 2, 256, seed=4)
    rout, rlse = fa._plain_fwd(q, k, v, False, 0.1, 558, bias)
    for a, b in zip(fa.flash_attention_bwd(q, k, v, rout, rlse, do, False,
                                           0.1, 558, bias),
                    fa._plain_bwd(q, k, v, rout, rlse, do, False, 0.1, 558,
                                  bias)):
        torch.testing.assert_close(a, b, **tol)
    _, k0, v0, _ = _qkvo(dev, 37, 2, 256, 4, 64, torch.float32)
    lse, delta = _global_stats(q, k, v, do, k0, v0, None)
    for a, b in zip(fa.flash_attention_bwd_ext(q, k, v, do, lse, delta, True),
                    fa._plain_bwd_ext(q, k, v, do, lse, delta, True)):
        torch.testing.assert_close(a, b, **tol)


# ---------------------------------------------------------------------------
# slice 2b: K2 over 2-byte inputs, K3's master-weight forms
# ---------------------------------------------------------------------------
def _tolerance_ratio(got, want, extra):
    """The largest |got - want| (want f32) over one unit of got's type at
    the larger of the two magnitudes plus ``extra``."""
    big = torch.maximum(got.abs(), want.abs().to(got.dtype))
    unit = (torch.nextafter(big, torch.full_like(big, float("inf")))
            - big).float()
    return float(((got.float() - want).abs() / (unit + extra)).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("N,H,V,ignored,h_scale", [
    (1000, 768, 3001, 0.15, 1.0),
    (1000, 768, 3001, 0.15, 8.0),
    (300, 16, 1000, 0.15, 1.0),
    (200, 1024, 777, 0.15, 1.0),
    (257, 768, 500, 1.0, 1.0),
], ids=["H768-ragged", "H768-peaked", "H16", "H1024", "all-ignored"])
def test_2byte_xent_matches_plain_and_is_deterministic(dev, dtype, N, H, V,
                                                       ignored, h_scale):
    """K2a/K2b's 2-byte forms (one tensor-core term a product): lse and
    the label logit within 1e-5 of their largest value of the plain
    version's (the f32 arithmetic on the upcast inputs); dh, dW and db in
    the inputs' type, element by element against the plain version's f32
    values, within one unit of the type plus four unit roundoffs of the
    2-norm of the element's terms (``_term_norms``: the rounding of P';
    db, an f32 sum: 2^-16 of their 1-norm) plus 1e-6 of the largest
    value; a second launch gives
    the same bits; one count of the type's form a call. h eight times
    larger gives a peaked softmax, whose part of dh the type resolves.
    f16's gradient is taken at a loss scale of 2^10, as f16 trains
    under a GradScaler."""
    g = torch.Generator(device=dev).manual_seed(41)
    h = (torch.randn((N, H), generator=g, device=dev) * h_scale).to(dtype)
    w = (torch.randn((V, H), generator=g, device=dev) * 0.02).to(dtype)
    b = (torch.randn((V,), generator=g, device=dev) * 0.02).to(dtype)
    lab = torch.randint(0, V, (N,), generator=g, device=dev,
                        dtype=torch.int32)
    drop = torch.rand((N,), generator=g, device=dev) < ignored
    lab = torch.where(drop, torch.full_like(lab, -1), lab)
    gr = (lab >= 0).float() / (lab >= 0).sum().clamp(min=1).float()
    gr = gr * (1024.0 if dtype == torch.float16 else 1.0)
    kind = fx.TWO_BYTE[dtype]
    first = fx.fused_xent_fwd(h, w, b, lab)
    first += fx.fused_xent_bwd(h, w, b, lab, first[0], gr)
    second = fx.fused_xent_fwd(h, w, b, lab)
    second += fx.fused_xent_bwd(h, w, b, lab, second[0], gr)
    rlse, rll = fx._plain_fwd(h, w, b, lab)
    up = [t.float() for t in (h, w, b)]
    f32 = fx._plain_bwd(*up, lab, first[0], gr)
    n2h, n2w, n1b = fx._term_norms(h, w, b, lab, first[0], gr)
    u = 2.0 ** (-8 if dtype == torch.bfloat16 else -11)
    extras = (4 * u * n2h, 4 * u * n2w, 2.0 ** -16 * n1b)
    torch.cuda.synchronize()
    for name, x, y in zip(("lse", "ll"), first, (rlse, rll)):
        assert x.dtype == torch.float32, name
        err = float((x - y).abs().max())
        assert err <= 1e-5 * float(y.abs().max()), (name, err)
    for name, x, y, e in zip(("dh", "dw", "db"), first[2:], f32, extras):
        assert x.dtype == dtype and bool(torch.isfinite(x).all()), name
        ratio = _tolerance_ratio(x, y, e + 1e-6 * float(y.abs().max()))
        assert ratio <= 1.0, (name, ratio)
    for name, x, y in zip(("lse", "ll", "dh", "dw", "db"), first, second):
        assert torch.equal(x.view(torch.int16 if x.element_size() == 2
                                  else torch.int32),
                           y.view(torch.int16 if y.element_size() == 2
                                  else torch.int32)), name
    if ignored == 1.0:
        assert all(int(torch.count_nonzero(x)) == 0 for x in first[2:])
    assert counters.snapshot() == {f"fused_xent_fwd_{kind}": 2,
                                   f"fused_xent_bwd_{kind}": 2}


def _master_case(dev, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = [(30592, 64), (768,), (3,), (0,), (1000, 7)]
    ws = [torch.randn(s, generator=g, device=dev) * 0.05 for s in shapes]
    gs = [(torch.randn(s, generator=g, device=dev) * 0.01).to(dtype)
          for s in shapes]
    ms = [torch.randn(s, generator=g, device=dev) * 0.01 for s in shapes]
    vs = [torch.rand(s, generator=g, device=dev) * 1e-4 for s in shapes]
    return [w.to(dtype) for w in ws], gs, ws, ms, vs


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
def test_master_forms_are_bitwise_the_plain_versions(dev, dtype):
    """Adam(W), Momentum, SGD (with and without its decay) and Lamb over
    bf16/f16 parameters with f32 masters: parameters, masters and state
    bit for bit the plain versions (Lamb's apply given the kernel's
    norms); each parameter its master's cast; one count of each master
    form a call; a skipped step launches nothing."""
    ps, gs, ws, ms, vs = _master_case(dev, dtype, 50)
    clone = (lambda xs: [x.clone() for x in xs])
    # Adam
    kp, kw, km, kv = clone(ps), clone(ws), clone(ms), clone(vs)
    hp = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, step=3,
              weight_decay=0.01)
    fo.fused_adam_(kp, gs, km, kv, masters=kw, **hp)
    fo.fused_adam_(kp, gs, km, kv, masters=kw, skip=True, **hp)
    pp, pw, pm, pv = clone(ps), clone(ws), clone(ms), clone(vs)
    lr, c1, c2, lrwd = fo.adam_scalars(1e-4, 0.9, 0.999, 3, 0.01)
    fo._plain_adam_(pw, fo._upcast(gs), pm, pv, lr, 0.9, 0.999, 1e-8, c1,
                    c2, lrwd, False)
    fo._cast_down_(pp, pw)
    torch.cuda.synchronize()
    assert _same(kp + kw + km + kv, pp + pw + pm + pv)
    assert _same(kp, [w.to(dtype) for w in kw])
    # Momentum
    kp, kw, kv = clone(ps), clone(ws), clone(vs)
    fo.fused_momentum_(kp, gs, kv, lr=0.1, momentum=0.9, nesterov=True,
                       masters=kw)
    pp, pw, pv = clone(ps), clone(ws), clone(vs)
    fo._plain_momentum_(pw, fo._upcast(gs), pv, np.float32(0.1),
                        np.float32(0.9), True, False)
    fo._cast_down_(pp, pw)
    torch.cuda.synchronize()
    assert _same(kp + kw + kv, pp + pw + pv)
    # SGD, without and with the decay (rounded in the parameter's type)
    for wd in (0.0, 1e-4):
        kp, kw = clone(ps), clone(ws)
        fo.fused_sgd_(kp, gs, lr=0.1, weight_decay=wd, masters=kw)
        pp, pw = clone(ps), clone(ws)
        pg = fo._plain_decay_2byte(pp, gs, fo.decay_in(dtype, wd)) \
            if wd else gs
        fo._plain_sgd_(pw, fo._upcast(pg), np.float32(0.1), np.float32(0),
                       False)
        fo._cast_down_(pp, pw)
        torch.cuda.synchronize()
        assert _same(kp + kw, pp + pw), wd
    # Lamb: the norms are the masters'
    kp, kw, km, kv = clone(ps), clone(ws), clone(ms), clone(vs)
    cache = {}
    fo.fused_lamb_(kp, gs, km, kv, [torch.empty_like(w) for w in ws],
                   lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-6,
                   weight_decay=0.01, step=3, masters=kw, cache=cache)
    pp, pw, pm, pv = clone(ps), clone(ws), clone(ms), clone(vs)
    rs = [torch.empty_like(w) for w in ws]
    lr, c1, c2, _ = fo.adam_scalars(1e-3, 0.9, 0.999, 3)
    fo._plain_lamb_phase1_(pw, fo._upcast(gs), pm, pv, rs, 0.9, 0.999, 1e-6,
                           0.01, c1, c2)
    fo._plain_lamb_apply_(pw, rs, fo.lamb_kernel_norms(cache), lr)
    fo._cast_down_(pp, pw)
    torch.cuda.synchronize()
    assert _same(kp + kw + km + kv, pp + pw + pm + pv)
    assert counters.snapshot() == {
        "fused_adam_master": 1, "fused_momentum_master": 1,
        "fused_sgd_master": 2, "fused_lamb_phase1_master": 1,
        "fused_lamb_apply_master": 1}


def _2byte_lists(dev, dtype, seed, scales, positive_last=False,
                 sizes=(1, 3, 4, 17, 1000, 4099)):
    """Lists of 2-byte tensors of ``sizes`` (every third an offset view,
    off the walker's 8-byte path), one list a scale, from a seed; the
    last list's absolute values with ``positive_last``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for i, scale in enumerate(scales):
        xs = []
        for k, n in enumerate(sizes):
            x = torch.randn(n + 1, generator=gen, device=dev) * scale
            if positive_last and i == len(scales) - 1:
                x = x.abs()
            x = x.to(dtype)
            xs.append(x[1:] if k % 3 == 2 else x[:n].clone())
        out.append(xs)
    return out


def _same_bits(a, b):
    """Two lists of 2-byte tensors equal as integers (NaN bits, -0.0)."""
    return all(x.view(torch.int16).equal(y.view(torch.int16))
               for x, y in zip(a, b))


def _two_runs(kernel, lists):
    """``kernel`` run on two copies of ``lists``; the copies."""
    runs = []
    for _ in range(2):
        k = [[x.clone() for x in xs] for xs in lists]
        kernel(k)
        runs.append(k)
    torch.cuda.synchronize()
    return runs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("rule", ["adam", "adamw", "momentum", "nesterov",
                                  "sgd", "sgd_l2", "lamb"])
def test_2byte_forms_without_masters_match_their_plain_versions(dev, dtype,
                                                                rule):
    """K3's 2-byte forms without masters (state in the parameters' type,
    each operation rounded to it): one launch a call (Lamb: phase 1 and
    the apply), bit for bit the plain version (Lamb's apply given the
    kernel's sums), two launches the same bits, a skipped call launching
    nothing."""
    tag = fo.TWO_BYTE[dtype]
    g_s = 1e-3 if dtype == torch.bfloat16 else 1e-2
    if rule in ("adam", "adamw", "lamb"):
        lists = _2byte_lists(dev, dtype, 4, (0.02, g_s, g_s / 10, g_s * g_s),
                             positive_last=True)
        if rule == "lamb":      # r, which the kernels overwrite
            lists.append([torch.zeros_like(p) for p in lists[0]])
    elif rule in ("momentum", "nesterov"):
        lists = _2byte_lists(dev, dtype, 5, (0.05, g_s, g_s))
    else:
        lists = _2byte_lists(dev, dtype, 6, (0.05, g_s))
    gs = lists[1]
    wd = {"adamw": 0.01, "sgd_l2": 1e-4, "lamb": 0.01}.get(rule, 0.0)
    caches = {}

    def kernel(k, skip=False):
        c = caches.setdefault(id(k[0]), {})
        if rule in ("adam", "adamw"):
            fo.fused_adam_(k[0], gs, k[2], k[3], lr=1e-3, beta1=0.9,
                           beta2=0.999, eps=1e-8, step=2, weight_decay=wd,
                           skip=skip, cache=c)
        elif rule == "lamb":
            fo.fused_lamb_(k[0], gs, k[2], k[3], k[4], lr=1e-3, beta1=0.9,
                           beta2=0.999, eps=1e-6, weight_decay=wd, step=2,
                           skip=skip, cache=c)
        elif rule in ("momentum", "nesterov"):
            fo.fused_momentum_(k[0], gs, k[2], lr=0.1, momentum=0.9,
                               nesterov=rule == "nesterov", skip=skip,
                               cache=c)
        else:
            fo.fused_sgd_(k[0], gs, lr=0.1, weight_decay=wd, skip=skip)

    names = {"lamb": ["fused_lamb_phase1_", "fused_lamb_apply_"],
             "momentum": ["fused_momentum_"], "nesterov": ["fused_momentum_"],
             "sgd": ["fused_sgd_"], "sgd_l2": ["fused_sgd_"]}.get(
                 rule, ["fused_adam_"])
    names = [n + tag for n in names]
    skipped = [[x.clone() for x in xs] for xs in lists]
    kernel(skipped, skip=True)
    assert counters.snapshot() == {}
    assert all(_same_bits(a, b) for a, b in zip(skipped, lists))
    first, second = _two_runs(kernel, lists)
    assert counters.snapshot() == {n: 2 for n in names}
    assert all(_same_bits(a, b) for a, b in zip(first, second))
    want = [[x.clone() for x in xs] for xs in lists]
    if rule in ("adam", "adamw"):
        fo._plain_adam_2byte_(want[0], gs, want[2], want[3],
                              fo.adam_scalars_2byte(dtype, 1e-3, 0.9, 0.999,
                                                    1e-8, 2, wd), False)
    elif rule == "lamb":
        sc = fo.adam_scalars_2byte(dtype, 1e-3, 0.9, 0.999, 1e-6, 2)
        fo._plain_lamb_phase1_2byte_(want[0], gs, want[2], want[3], want[4],
                                     sc, fo.decay_in(dtype, wd))
        sums = fo.lamb_kernel_sums(caches[id(first[0])])
        assert torch.allclose(sums, fo._lamb_sums_2byte(want[0], want[4]),
                              rtol=1e-6, atol=0)
        fo._plain_lamb_apply_2byte_(want[0], want[4], sums, sc[0])
    elif rule in ("momentum", "nesterov"):
        fo._plain_momentum_2byte_(want[0], gs, want[2],
                                  fo.decay_in(dtype, 0.1),
                                  fo.decay_in(dtype, 0.9),
                                  rule == "nesterov", False)
    else:
        fo._plain_sgd_2byte_(want[0], gs, fo.decay_in(dtype, 0.1),
                             fo.decay_in(dtype, wd) if wd else 0.0, False)
    for i, (a, b) in enumerate(zip(first, want)):
        assert _same_bits(a, b), (i, [int((x.view(torch.int16)
                                          != y.view(torch.int16)).sum())
                                      for x, y in zip(a, b)])


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_2byte_parameters_without_masters_launch_once_a_group(dev, dtype):
    """``decorate(master_weight=False)`` leaves bf16/f16 parameters
    without f32 masters: each optimizer's step launches the 2-byte form
    once for the group (Lamb: phase 1 and the apply), bit for bit the
    same step run by the plain versions on the CPU (Lamb given the same
    sums), the moments in the parameters' type."""
    import copy

    from paddle_tpu_torch import amp, nn, optimizer

    tag = "bf16" if dtype == "bfloat16" else "f16"
    base = nn.Linear(8, 4, device="cpu")
    for name, make in (
            ("sgd", lambda ps: optimizer.SGD(0.1, parameters=ps,
                                             weight_decay=1e-4)),
            ("momentum", lambda ps: optimizer.Momentum(0.1, parameters=ps)),
            ("adam", lambda ps: optimizer.AdamW(1e-3, parameters=ps)),
            ("lamb_phase1", lambda ps: optimizer.Lamb(1e-3, parameters=ps))):
        runs = {}
        for where in (dev, torch.device("cpu")):
            layer = copy.deepcopy(base).to(where)
            opt = make(list(layer.parameters()))
            amp.decorate(layer, opt, level="O2", dtype=dtype,
                         master_weight=False)
            gen = torch.Generator().manual_seed(1)
            for p in layer.parameters():
                p.grad = (torch.randn(p.shape, generator=gen)
                          * 1e-2).to(p.dtype).to(where)
            counters.reset()
            opt.step()
            runs[where.type] = ([p.detach().cpu() for p in layer.parameters()],
                                counters.snapshot(), opt)
        got, launched, opt = runs["cuda"]
        want = {"fused_" + name + "_" + tag: 1}
        if name == "lamb_phase1":
            want["fused_lamb_apply_" + tag] = 1
        assert launched == want, (name, launched)
        assert all(v.dtype == got[0].dtype
                   for s in opt._slots.values() for v in s.values())
        if name != "lamb_phase1":    # Lamb's sums are taken in other orders
            assert _same(got, runs["cpu"][0]), name


def test_slice_2b_kernels_raise_on_what_they_do_not_take(dev):
    p = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="bf16 or f16"):
        fo.fused_adam_([p], [p], [p], [p], lr=1e-3, beta1=0.9, beta2=0.999,
                       eps=1e-8, step=1, masters=[p])
    h = torch.zeros((4, 16), device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="one type"):
        fx.fused_xent_fwd(h, torch.zeros((8, 16), device=dev),
                          torch.zeros(8, device=dev),
                          torch.zeros(4, dtype=torch.int32, device=dev))
    lo = torch.zeros(8, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="f32"):
        fo.fused_momentum_([lo], [lo], [lo], lr=0.1, momentum=0.9,
                           nesterov=False, masters=[p])
    assert counters.snapshot() == {}


# ---------------------------------------------------------------------------
# K1a/K1b over f16 (AMP O1 fp16)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,Lq,Lk,causal,p,masked,scale", [
    (8, 128, 128, False, 0.1, False, 2.0 ** 15),
    (8, 128, 128, True, 0.1, False, 2.0 ** 15),
    (8, 128, 128, True, 0.1, False, 1.0),
    (8, 128, 128, False, 0.1, True, 2.0 ** 15),
    (8, 17, 128, False, 0.0, False, 2.0 ** 15),
    (8, 1, 1, True, 0.0, False, 2.0 ** 15),
], ids=["cross", "causal", "causal-scale1", "masked", "decode-Lq17",
        "decode-L1"])
def test_f16_flash_kernels_hold_the_2byte_rule(dev, B, Lq, Lk, causal, p,
                                               masked, scale):
    """K1a/K1b's f16 forms against the plain version in f32, element by
    element (``chip_smoke.flash_2byte_vs_plain``: one f16 unit plus four
    unit roundoffs of the terms' 2-norm, with the f32 sums' allowance),
    dO at ``scale`` times a unit gradient; a second launch the same bits;
    the launches counted under the f16 names."""
    import chip_smoke as cs

    gen = torch.Generator(device=dev).manual_seed(41)
    q, k, v, do = cs.attention_inputs(torch, gen, B, Lq, Lk, 8, 64,
                                      torch.float16, do_scale=scale)
    bias = _padded_bias(dev, B, Lk) if masked else None
    _, _, got = cs.flash_2byte_vs_plain(torch, fa, q, k, v, do, causal, p,
                                        42, bias)
    again = fa._cuda_fwd(q, k, v, causal, p, 42, bias) + fa._cuda_bwd(
        q, k, v, got[0], got[1], do, causal, p, 42, bias)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    name = "masked_" if masked else ""
    assert counters.snapshot() == {f"flash_attention_{name}fwd_f16": 2,
                                   f"flash_attention_{name}bwd_f16": 2}


# ---------------------------------------------------------------------------
# K1c/K1d and the external-lse K1b over f16 (BERT phase 2 and GPT-2 over
# {"sp": 2} at O1 fp16)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,L,H,D,causal,scale", [
    (4, 512, 4, 64, False, 1.0),
    (4, 512, 4, 64, False, 2.0 ** 15),
    (4, 256, 4, 64, True, 1.0),
    (2, 384, 4, 128, False, 1.0),
    (4, 128, 4, 64, True, 2.0 ** 15),
], ids=["L512-scale1", "L512-scale2^15", "causal-L256", "D128-L384",
        "causal-L128"])
def test_f16_short_kernels_hold_the_2byte_rule(dev, B, L, H, D, causal,
                                               scale):
    """K1c/K1d's f16 forms (clusters of L / 64 CTAs) against the plain
    version in f32 by the 2-byte rule, dropout 0.1, dO at ``scale``
    times a unit gradient; a second launch the same bits; K1c f16's lse
    K1a f16's bit for bit; the launches counted under the f16 names."""
    import chip_smoke as cs

    gen = torch.Generator(device=dev).manual_seed(43)
    q, k, v, do = cs.attention_inputs(torch, gen, B, L, L, H, D,
                                      torch.float16, do_scale=scale)
    _, _, got = cs.flash_2byte_vs_plain(torch, fa, q, k, v, do, causal, 0.1,
                                        44, form="short")
    again = fa._cuda_short_fwd(q, k, v, causal, 0.1, 44) + \
        fa._cuda_short_bwd(q, k, v, got[0], got[1], do, causal, 0.1, 44)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert torch.equal(got[1], fa._cuda_fwd(q, k, v, causal, 0.1, 44)[1])
    assert counters.snapshot() == {"flash_attention_short_fwd_f16": 2,
                                   "flash_attention_short_bwd_f16": 2,
                                   "flash_attention_fwd_f16": 1}


@pytest.mark.parametrize("causal,k0_mul,scale", [
    (False, 1.0, 1.0), (True, 1.0, 1.0), (False, 4.0, 1.0),
    (False, 4.0, 2.0 ** 15)],
    ids=["full", "diagonal", "little-mass", "little-mass-scale2^15"])
def test_f16_ext_backward_holds_the_2byte_rule(dev, causal, k0_mul, scale):
    """The external-lse K1b over f16 at a ring block (B 4, 256 rows, the
    lse and delta of two blocks; "little mass": the other block's keys x
    4, so this block holds little of each row's softmax) against its
    plain version by the 2-byte rule; two launches the same bits; counted
    as ``flash_attention_ext_bwd_f16``."""
    import chip_smoke as cs

    B, L, H, D = 4, 256, 4, 64
    gen = torch.Generator(device=dev).manual_seed(45)
    q, k, v, do = cs.attention_inputs(torch, gen, B, L, L, H, D,
                                      torch.float16, do_scale=scale)
    k0, v0 = (torch.randn((B, L, H, D), generator=gen, device=dev) * m
              for m in (k0_mul, 1.0))
    out, lse = fa._plain_fwd(q.float(), torch.cat([k0, k.float()], 1),
                             torch.cat([v0, v.float()], 1), False, 0.0, 0)
    out = out.half()
    _, _, got = cs.flash_2byte_vs_plain(torch, fa, q, k, v, do, causal, 0.0,
                                        0, form="ext", glob=(out, lse))
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(B * H, L).contiguous()
    for a, b in zip(got, fa.flash_attention_bwd_ext(q, k, v, do, lse, delta,
                                                    causal)):
        assert torch.equal(a, b)
    assert counters.snapshot() == {"flash_attention_ext_bwd_f16": 2}
