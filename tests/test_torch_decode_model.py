"""The port's decode model (paddle_tpu_torch.inference.decode.model)
against the JAX package's, on the CPU: JAX params carried over through
params_from_numpy; dense, prefill and decode forwards agree within
atol 1e-4 (f32 sums in another order), greedy tokens bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.decode import model as jm
from paddle_tpu_torch.inference.decode import model as tm

ATOL = 1e-4

JCFG = jm.DecodeModelConfig(vocab_size=32, n_layers=2, n_heads=2,
                            head_dim=8, ffn_dim=32, max_context=64)
TCFG = tm.DecodeModelConfig(**JCFG.to_dict())


@pytest.fixture(scope="module")
def params():
    jp = jm.init_decode_params(JCFG, 3)
    tp = tm.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                              device="cpu")
    return jp, tp


def _tokens(b, l, seed):
    return np.random.RandomState(seed).randint(0, 32, (b, l)).astype(
        np.int32)


def test_params_from_numpy_carries_every_tensor(params):
    jp, tp = params
    assert set(tp) == set(jp)
    for k in jp:
        assert tp[k].dtype == torch.float32 and tp[k].device.type == "cpu"
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_dense_forward_matches_jax(params):
    jp, tp = params
    toks = _tokens(3, 11, 0)
    jl, jk, jv = jm.dense_forward(JCFG, jp, jnp.asarray(toks),
                                  collect_kv=True)
    tl, tk, tv = tm.dense_forward(TCFG, tp, torch.from_numpy(toks),
                                  collect_kv=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                  np.asarray(jl).argmax(-1))


@pytest.mark.parametrize("return_logits", [False, True])
def test_prefill_forward_matches_jax(params, return_logits):
    jp, tp = params
    toks = _tokens(2, 16, 1)
    lens = np.asarray([9, 16], np.int32)
    jo, jk, _ = jm.prefill_forward(JCFG, jp, jnp.asarray(toks),
                                   jnp.asarray(lens), return_logits)
    to, tk, _ = tm.prefill_forward(TCFG, tp, torch.from_numpy(toks),
                                   torch.from_numpy(lens), return_logits)
    if return_logits:
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    else:
        assert to.dtype == torch.int32
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_decode_forward_matches_jax(params, quant):
    """One ragged decode step over the same pools: logits within
    atol, greedy tokens equal, the pools written the same way (the
    port in place, JAX functionally) outside the trash page."""
    jp, tp = params
    rng = np.random.RandomState(4)
    L, P, S, H, D = 2, 10, 4, 2, 8
    if quant:
        kp = rng.randint(-127, 128, (L, P, S, H, D)).astype(np.int8)
        vp = rng.randint(-127, 128, (L, P, S, H, D)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (L, P, S)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, (L, P, S)).astype(np.float32)
    else:
        kp = rng.randn(L, P, S, H, D).astype(np.float32)
        vp = rng.randn(L, P, S, H, D).astype(np.float32)
        ks = vs = None
    tokens = np.asarray([3, 17, 5], np.int32)
    positions = np.asarray([6, 1, 10], np.int32)
    table = np.asarray([[1, 2, -1], [3, -1, -1], [4, 5, 6]], np.int32)
    active = np.asarray([True, True, False])
    jargs = [jnp.asarray(a) for a in (tokens, positions, kp, vp, table,
                                      positions, active)]
    jkw = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs)) \
        if quant else {}
    jout = jm.decode_forward(JCFG, jp, *jargs, return_logits=True, **jkw)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tkw = dict(k_scales=torch.from_numpy(ks.copy()),
               v_scales=torch.from_numpy(vs.copy())) if quant else {}
    tl = tm.decode_forward(
        TCFG, tp, torch.from_numpy(tokens), torch.from_numpy(positions),
        tk, tv, torch.from_numpy(table), torch.from_numpy(positions),
        torch.from_numpy(active), return_logits=True, **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jout[0]), atol=ATOL)
    greedy = tm.decode_forward(
        TCFG, tp, torch.from_numpy(tokens), torch.from_numpy(positions),
        tk.clone(), tv.clone(), torch.from_numpy(table),
        torch.from_numpy(positions), torch.from_numpy(active),
        **{k: v.clone() for k, v in tkw.items()})
    np.testing.assert_array_equal(greedy.numpy(),
                                  np.asarray(jout[0]).argmax(-1))
    if quant:
        # row payloads may differ by one step where the K/V rows
        # themselves differ in the last bit; the scales by a few ulp
        np.testing.assert_allclose(tk.numpy()[:, 1:].astype(np.int32),
                                   np.asarray(jout[1])[:, 1:], atol=1)
        np.testing.assert_allclose(tkw["k_scales"].numpy()[:, 1:],
                                   np.asarray(jout[3])[:, 1:], rtol=1e-5)
    else:
        np.testing.assert_allclose(tk.numpy()[:, 1:],
                                   np.asarray(jout[1])[:, 1:], atol=ATOL)
        np.testing.assert_allclose(tv.numpy()[:, 1:],
                                   np.asarray(jout[2])[:, 1:], atol=ATOL)


@pytest.mark.parametrize("prompt", [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10],
                                    [11, 12]])
def test_reference_generate_matches_jax(params, prompt):
    jp, tp = params
    assert tm.reference_generate(TCFG, tp, prompt, 8) == \
        jm.reference_generate(JCFG, jp, prompt, 8)


def test_init_decode_params_is_seeded_on_the_device():
    a = tm.init_decode_params(TCFG, seed=5, device="cpu")
    b = tm.init_decode_params(TCFG, seed=5, device="cpu")
    c = tm.init_decode_params(TCFG, seed=6, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["l0.wq"], c["l0.wq"])
    assert a["head"].shape == (TCFG.hidden, TCFG.vocab_size)
    assert not torch.backends.cuda.matmul.allow_tf32
