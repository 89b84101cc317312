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
