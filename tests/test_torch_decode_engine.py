"""The port's decode engine (paddle_tpu_torch DecodeEngine on
device="cpu", where every kernel runs its plain version) against the
JAX package: the dense greedy oracle for mixed lengths, continuous
arrival, preemption under pool pressure and a prefix-cache hit; the
JAX engine itself for the int8 pool and for seeded sampling. Plus the
typed admission errors, the option of a later slice that must raise
(``mesh_shape``), and the no-silent-CPU rule of the entry points. The
async tick, speculative decoding, the host KV tier and page adoption
have files of their own (``test_torch_decode_async.py``,
``test_torch_decode_spec.py``, ``test_torch_disagg.py``)."""
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.inference.decode import DecodeEngine as JaxEngine
from paddle_tpu.inference.decode import DecodeModelConfig as JaxConfig
from paddle_tpu.inference.decode import init_decode_params as jax_init
from paddle_tpu.inference.decode import reference_generate as jax_ref
from paddle_tpu_torch.inference import (DeadlineExceeded, EngineStopped,
                                        Overloaded, RequestFailed)
from paddle_tpu_torch.inference.decode import (DecodeEngine,
                                               DecodeModelConfig,
                                               alloc_kv_pool,
                                               init_decode_params)

JCFG = JaxConfig(vocab_size=32, n_layers=2, n_heads=2, head_dim=8,
                 ffn_dim=32, max_context=64)
CFG = DecodeModelConfig(**JCFG.to_dict())
GEOM = dict(max_batch=3, n_pages=32, page_size=8, max_pages_per_seq=8)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11, 12]]


def _drive(eng, max_ticks=500):
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


def _engine(np_params, **kw):
    args = dict(GEOM)
    args.update(kw)
    eng = DecodeEngine(CFG, params=np_params, device="cpu", **args)
    eng.warm()
    return eng


def test_mixed_length_batch_matches_jax_oracle(np_params, jparams):
    eng = _engine(np_params)
    hs = [eng.submit(p, max_new_tokens=6) for p in PROMPTS]
    _drive(eng)
    assert [h.result(timeout=5) for h in hs] == \
        [jax_ref(JCFG, jparams, p, 6) for p in PROMPTS]
    assert eng.counters["decode_steps"] > 0
    assert eng.pool.pages_in_use == 0
    stats = eng.engine_latency_stats()
    assert stats["n"] == len(PROMPTS) and stats["step_p50_ms"] > 0
    meta = hs[0].stats()
    assert len(meta["token_times"]) == 6 and meta["ttft_ms"] >= 0
    assert len(meta["trace_id"]) == 16


def test_continuous_arrival_joins_running_batch(np_params, jparams):
    eng = _engine(np_params)
    h1 = eng.submit([7, 3, 1, 2], max_new_tokens=10)
    for _ in range(4):
        eng.run_once()
    assert not h1.done()
    h2 = eng.submit([9, 8], max_new_tokens=5)
    _drive(eng)
    assert h1.result(timeout=5) == jax_ref(JCFG, jparams, [7, 3, 1, 2], 10)
    assert h2.result(timeout=5) == jax_ref(JCFG, jparams, [9, 8], 5)


def test_preemption_under_pool_pressure_matches_jax_oracle():
    jcfg = JaxConfig(vocab_size=32, n_layers=1, n_heads=2, head_dim=8,
                     ffn_dim=16, max_context=24)
    jp = jax_init(jcfg, 7)
    eng = DecodeEngine(DecodeModelConfig(**jcfg.to_dict()),
                       params={k: np.asarray(v) for k, v in jp.items()},
                       max_batch=2, n_pages=8, page_size=4,
                       max_pages_per_seq=6, device="cpu")
    prompts = [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10, 11]]
    hs = [eng.submit(p, max_new_tokens=10) for p in prompts]
    _drive(eng)
    assert [h.result(timeout=5) for h in hs] == \
        [jax_ref(jcfg, jp, p, 10) for p in prompts]
    c = eng.counters
    assert c["decode_preempted"] >= 1 and c["kv_page_evictions"] >= 1
    assert eng.pool.pages_in_use == 0
    assert any(h.stats().get("preempted") for h in hs)


def test_prefix_cache_hit_shares_pages_and_matches(np_params, jparams):
    eng = _engine(np_params, max_batch=2)
    prompt = list(range(1, 18))                    # 17 tokens: 2 full pages
    out1 = _serve(eng, [prompt], 6)[0]
    assert eng.counters["kv_prefix_hits"] == 0
    reclaimed = eng.pool.snapshot()["cached_reclaimed"]
    out2 = _serve(eng, [prompt], 6)[0]
    assert out1 == out2 == jax_ref(JCFG, jparams, prompt, 6)
    assert eng.counters["kv_prefix_hits"] == 2     # (17-1)//8 pages
    assert eng.pool.snapshot()["cached_reclaimed"] == reclaimed


def test_cow_guard_copies_the_shared_page(np_params):
    from types import SimpleNamespace

    eng = _engine(np_params, max_batch=2, n_pages=16, max_pages_per_seq=4)
    pool = eng.pool
    toks = list(range(8))
    p1 = pool.alloc_seq(101, 8)
    pool.register_prefix(101, toks)
    pool.alloc_seq_shared(102, pool.match_prefix(toks + [9]), 9)
    eng._k_pages[:, p1[0]] = 7.0
    eng._maybe_cow(SimpleNamespace(seq_id=102, length=2))
    assert eng.counters.get("kv_cow_copies", 0) == 1
    dst = pool.seq_pages(102)[0]
    assert dst != p1[0] and pool.seq_pages(101)[0] == p1[0]
    assert bool((eng._k_pages[:, dst] == 7.0).all())


def _jax_engine_tokens(jparams, prompts, max_new, **kw):
    eng = JaxEngine(JCFG, params=jparams, **GEOM, **kw)
    eng.warm()
    hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    _drive(eng)
    return [h.result(timeout=5) for h in hs]


def test_int8_pool_engine_matches_jax_int8_engine(np_params, jparams):
    eng = _engine(np_params, kv_codec="int8")
    assert eng._k_pages.dtype == torch.int8
    assert eng._k_scales.shape == eng._k_pages.shape[:3]
    ours = _serve(eng, PROMPTS, 8)
    assert ours == _jax_engine_tokens(jparams, PROMPTS, 8, kv_codec="int8")


def test_sampling_engine_replays_the_jax_engine(np_params, jparams):
    kw = dict(temperature=0.8, top_k=4, sample_seed=11)
    ours = _serve(_engine(np_params, **kw), PROMPTS, 8)
    assert ours == _serve(_engine(np_params, **kw), PROMPTS, 8)
    assert ours == _jax_engine_tokens(jparams, PROMPTS, 8, **kw)
    assert all(0 <= t < CFG.vocab_size for out in ours for t in out)


def test_eos_stops_generation(np_params, jparams):
    ref = jax_ref(JCFG, jparams, [4, 5, 6, 7, 8, 9, 10], 6)
    eng = _engine(np_params, eos_id=ref[2])
    assert _serve(eng, [[4, 5, 6, 7, 8, 9, 10]], 6)[0] == ref[:3]


def test_threaded_start_generate_drain(np_params, jparams):
    eng = _engine(np_params)
    assert not eng.ready
    eng.start()
    assert eng.ready
    assert eng.generate([2, 4, 6], max_new_tokens=5, timeout=30) == \
        jax_ref(JCFG, jparams, [2, 4, 6], 5)
    h = eng.submit([5, 5], max_new_tokens=4)
    assert eng.drain(timeout=30)
    assert h.result(timeout=5) == jax_ref(JCFG, jparams, [5, 5], 4)
    with pytest.raises(EngineStopped):
        eng.submit([1], 2)
    assert not eng.ready


def test_drain_waits_for_a_request_in_prefill(np_params, jparams):
    """A request popped for prefill is neither queued nor in a slot
    until its prefill ends, yet it is pending: drain waits for it and
    serves it. A slow prefill makes the window certain here; under a
    loaded machine it opens by itself."""
    eng = _engine(np_params)
    real = eng._prefill_one
    entered = threading.Event()

    def slow(req):
        entered.set()
        time.sleep(0.3)
        return real(req)

    eng._prefill_one = slow
    eng.start()
    h = eng.submit([5, 5], max_new_tokens=4)
    assert entered.wait(30)
    assert eng.sched.pending()
    assert eng.drain(timeout=30)
    assert h.result(timeout=5) == jax_ref(JCFG, jparams, [5, 5], 4)


def test_decode_step_failure_fails_typed_and_recovers(np_params, jparams):
    eng = _engine(np_params)
    real = eng._step
    calls = {"n": 0}

    def flaky(*a):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected step failure")
        return real(*a)

    eng._step = flaky
    h = eng.submit([1, 2, 3], max_new_tokens=6)
    _drive(eng)
    with pytest.raises(RequestFailed):
        h.result(timeout=5)
    assert eng.counters["decode_failed"] == 1
    assert _serve(eng, [[1, 2, 3]], 6)[0] == \
        jax_ref(JCFG, jparams, [1, 2, 3], 6)


def test_admission_sheds_typed(np_params):
    t = [0.0]
    eng = _engine(np_params, max_queue=2, min_service_s=0.5,
                  clock=lambda: t[0])
    eng.submit([1], 4)
    eng.submit([1], 4)
    with pytest.raises(Overloaded):
        eng.submit([1], 4)
    _drive(eng)
    with pytest.raises(DeadlineExceeded):
        eng.submit([1], 4, deadline_s=0.1)
    with pytest.raises(ValueError):
        eng.submit([1] * 60, 10)     # 70 > 8 pages x 8 tokens
    with pytest.raises(ValueError):
        eng.submit([], 4)
    h = eng.submit([1], 4, deadline_s=1.0)
    t[0] = 2.0
    eng.run_once()
    with pytest.raises(DeadlineExceeded):
        h.result(timeout=0)


@pytest.mark.parametrize("kw", [dict(mesh_shape={"tp": 2})],
                         ids=["mesh_shape"])
def test_later_slice_options_raise(np_params, kw):
    with pytest.raises(NotImplementedError, match="later port slice"):
        DecodeEngine(CFG, params=np_params, device="cpu", **GEOM, **kw)


@pytest.mark.parametrize("entry", ["engine", "init", "pool"])
def test_entry_points_without_a_gpu_raise_and_name_cpu(monkeypatch, entry,
                                                       np_params):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "engine":
            DecodeEngine(CFG, params=np_params, **GEOM)
        elif entry == "init":
            init_decode_params(CFG, seed=0)
        else:
            alloc_kv_pool(2, 4, 8, 2, 8)
