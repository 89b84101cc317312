"""The port's speculative decoding (paddle_tpu_torch spec.py,
model.spec_decode_forward and the engine's spec tick, on device="cpu")
against the JAX package from the same numpy params: the n-gram proposer
draft for draft, the verify step over f32 and int8 pools (greedy
columns equal, the pools written the same way), and spec engines token
for token against the JAX spec engine and the dense oracle with mixed
lengths, continuous arrival, preemption and an int8 pool."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.decode import DecodeEngine as JaxEngine
from paddle_tpu.inference.decode import DecodeModelConfig as JaxConfig
from paddle_tpu.inference.decode import NgramProposer as JaxProposer
from paddle_tpu.inference.decode import init_decode_params as jax_init
from paddle_tpu.inference.decode import model as jm
from paddle_tpu_torch.inference.decode import (DecodeEngine,
                                               DecodeModelConfig,
                                               NgramProposer)
from paddle_tpu_torch.inference.decode import model as tm

JCFG = JaxConfig(vocab_size=32, n_layers=2, n_heads=2, head_dim=8,
                 ffn_dim=32, max_context=64)
CFG = DecodeModelConfig(**JCFG.to_dict())
GEOM = dict(max_batch=3, n_pages=32, page_size=8, max_pages_per_seq=8)
LOOP_PROMPT = [5, 9, 2, 5, 9, 2, 5, 9, 2, 5, 9, 2]     # period-3 motif
PROMPTS = [LOOP_PROMPT, [4, 5, 6, 7, 8, 9, 10], [11, 12]]


def _drive(eng, max_ticks=800):
    for _ in range(max_ticks):
        if not eng.sched.pending():
            return
        eng.run_once()
    raise AssertionError("engine did not drain the workload")


def _serve(eng, prompts, max_new):
    hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    _drive(eng)
    return [h.result(timeout=5) for h in hs]


@pytest.fixture(scope="module")
def jparams():
    return jax_init(JCFG, 3)


@pytest.fixture(scope="module")
def np_params(jparams):
    return {k: np.asarray(v) for k, v in jparams.items()}


@pytest.fixture(scope="module")
def jax_spec_outputs(jparams):
    """The JAX spec engine (spec_k 3) over PROMPTS, f32 and int8 pools,
    with its counters."""
    out = {}
    for codec in ("off", "int8"):
        eng = JaxEngine(JCFG, params=jparams, spec_k=3,
                        proposer=JaxProposer(), kv_codec=codec, **GEOM)
        out[codec] = (_serve(eng, PROMPTS, 10), eng.counters)
    return out


def _oracle(np_params, prompt, n, cfg=CFG):
    """The dense greedy oracle: the port's ``reference_generate``, held
    to JAX's in test_torch_decode_model.py (JAX's compiles a forward for
    every length, seconds each here)."""
    tp = tm.params_from_numpy(np_params, device="cpu")
    return tm.reference_generate(cfg, tp, prompt, n)


def _spec_engine(np_params, spec_k=3, **kw):
    args = dict(GEOM)
    args.update(kw)
    eng = DecodeEngine(CFG, params=np_params, device="cpu", spec_k=spec_k,
                       proposer=NgramProposer(), **args)
    eng.warm()
    return eng


# ---------------------------------------------------------------------------
# the proposer
# ---------------------------------------------------------------------------
def _contexts():
    rng = np.random.RandomState(0)
    out = [[1, 2, 3, 1, 2, 3, 1, 2], [7, 1, 7, 5, 7], [4, 8, 9, 8],
           [1, 2, 3], [1], [1, 1], [], LOOP_PROMPT,
           [300, 5, 300, 5, 300], [1000, 2, 3, 1000, 2]]
    for n in (5, 20, 60):
        out.append(rng.randint(0, 6, n).tolist())        # byte vocab
        out.append(rng.randint(250, 262, n).tolist())    # past a byte
    return out


@pytest.mark.parametrize("max_n", [1, 3, 5])
def test_ngram_proposer_matches_jax(max_n):
    ours, theirs = NgramProposer(max_n=max_n), JaxProposer(max_n=max_n)
    for ctx in _contexts():
        for k in (0, 1, 2, 4):
            assert ours.propose(ctx, k) == theirs.propose(ctx, k), (ctx, k)
    assert NgramProposer(max_n=3).propose([1, 2, 3, 1, 2, 3, 1, 2], 3) \
        == [3, 1, 2]
    with pytest.raises(ValueError):
        NgramProposer(max_n=0)


# ---------------------------------------------------------------------------
# the verify step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_spec_decode_forward_matches_jax(np_params, jparams, quant):
    """B·(K+1) ragged rows over the same pools: the greedy columns are
    equal, the pools written the same (the port in place, JAX
    functionally) outside the trash page 0, where dead columns land in
    any order: f32 rows within 1e-6, int8 payloads bit for bit and
    their scales within one part in 10^6."""
    tp = tm.params_from_numpy(np_params, device="cpu")
    rng = np.random.RandomState(11)
    L, P, S, H, D = 2, 12, 4, 2, 8
    if quant:
        kp = rng.randint(-127, 128, (L, P, S, H, D)).astype(np.int8)
        vp = rng.randint(-127, 128, (L, P, S, H, D)).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (L, P, S)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, (L, P, S)).astype(np.float32)
    else:
        kp = rng.randn(L, P, S, H, D).astype(np.float32)
        vp = rng.randn(L, P, S, H, D).astype(np.float32)
        ks = vs = None
    tokens = rng.randint(0, 32, (3, 4)).astype(np.int32)
    positions = np.asarray([6, 1, 9], np.int32)
    table = np.asarray([[1, 2, 3, -1], [4, 5, -1, -1], [6, 7, 8, 9]],
                       np.int32)
    active = np.asarray([[True, True, True, False],
                         [True, False, False, False],
                         [True, True, True, True]])
    jkw = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs)) \
        if quant else {}
    jout = jm.spec_decode_forward(
        JCFG, jparams, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(positions), jnp.asarray(active), **jkw)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tkw = dict(k_scales=torch.from_numpy(ks.copy()),
               v_scales=torch.from_numpy(vs.copy())) if quant else {}
    greedy = tm.spec_decode_forward(
        CFG, tp, torch.from_numpy(tokens), torch.from_numpy(positions),
        tk, tv, torch.from_numpy(table), torch.from_numpy(positions),
        torch.from_numpy(active), **tkw)
    assert greedy.dtype == torch.int32 and greedy.shape == (3, 4)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jout[0]))
    pools = [tk, tv] + ([tkw["k_scales"], tkw["v_scales"]] if quant else [])
    for i, (ours, theirs) in enumerate(zip(pools, jout[1:])):
        if quant and i < 2:     # the int8 payloads
            np.testing.assert_array_equal(ours.numpy()[:, 1:],
                                          np.asarray(theirs)[:, 1:])
        elif quant:
            # a scale is its row's amax / 127, and the rows themselves
            # differ in their last bits (f32 sums in another order)
            np.testing.assert_allclose(ours.numpy()[:, 1:],
                                       np.asarray(theirs)[:, 1:],
                                       rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(ours.numpy()[:, 1:],
                                       np.asarray(theirs)[:, 1:],
                                       atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# spec engines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", ["off", "int8"])
def test_spec_engine_matches_jax_spec_engine_and_oracle(np_params,
                                                        jax_spec_outputs,
                                                        codec):
    eng = _spec_engine(np_params, kv_codec=codec)
    assert eng._async_decode is False
    outs = _serve(eng, PROMPTS, 10)
    jax_outs, jax_counters = jax_spec_outputs[codec]
    assert outs == jax_outs
    if codec == "off":
        assert outs == [_oracle(np_params, p, 10) for p in PROMPTS]
    c = eng.counters
    for name in ("spec_proposed", "spec_accepted", "decode_steps"):
        assert c[name] == jax_counters[name], name
    assert c["spec_accepted"] > 0
    assert c["spec_accept_rate"] == pytest.approx(
        c["spec_accepted"] / c["spec_proposed"], abs=1e-3)
    # accepted drafts are steps never run
    assert c["decode_steps"] < 10 * len(PROMPTS)
    assert eng.kv_debug_snapshot()["spec_k"] == 3


def test_spec_continuous_arrival_joins_running_batch(np_params):
    eng = _spec_engine(np_params)
    h1 = eng.submit(LOOP_PROMPT, max_new_tokens=10)
    for _ in range(3):
        eng.run_once()
    assert not h1.done()
    h2 = eng.submit([9, 8], max_new_tokens=5)
    _drive(eng)
    assert h1.result(timeout=5) == _oracle(np_params, LOOP_PROMPT, 10)
    assert h2.result(timeout=5) == _oracle(np_params, [9, 8], 5)


def test_spec_preemption_under_pool_pressure_preserves_outputs():
    """Draft growth never preempts a peer: under pool pressure k
    shrinks, and a preempted request re-prefills to the oracle's
    tokens."""
    jcfg = JaxConfig(vocab_size=32, n_layers=1, n_heads=2, head_dim=8,
                     ffn_dim=16, max_context=24)
    cfg = DecodeModelConfig(**jcfg.to_dict())
    np_p = {k: np.asarray(v) for k, v in jax_init(jcfg, 7).items()}
    eng = DecodeEngine(cfg, params=np_p, max_batch=2, n_pages=8,
                       page_size=4, max_pages_per_seq=6, spec_k=2,
                       proposer=NgramProposer(), device="cpu")
    eng.warm()
    prompts = [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10, 11]]
    assert _serve(eng, prompts, 10) == \
        [_oracle(np_p, p, 10, cfg) for p in prompts]
    assert eng.pool.pages_in_use == 0


def test_spec_k_0_is_the_plain_step(np_params):
    """spec_k=0 is the off switch: one token a step, no drafts."""
    eng = _spec_engine(np_params, spec_k=0, async_decode=False)
    assert _serve(eng, [LOOP_PROMPT], 8)[0] == \
        _oracle(np_params, LOOP_PROMPT, 8)
    c = eng.counters
    assert c.get("spec_proposed", 0) == 0 and c["decode_steps"] == 7


def test_spec_requires_greedy_temperature(np_params):
    with pytest.raises(ValueError, match="temperature"):
        DecodeEngine(CFG, params=np_params, device="cpu", spec_k=2,
                     temperature=0.7, **GEOM)
    with pytest.raises(ValueError, match="spec_k"):
        DecodeEngine(CFG, params=np_params, device="cpu", spec_k=-1,
                     **GEOM)
