"""The port's async decode tick and host KV tier (paddle_tpu_torch
DecodeEngine on device="cpu", every kernel its plain version) against the
JAX package, mirroring ``tests/test_decode_async.py``: greedy tokens of
the lagged, device-chained tick bitwise the port's own synchronous tick
(``async_decode=False``), the JAX engine and the dense oracle across
mixed lengths, continuous arrival, budget stops, preemption, page
growth and spec composition; the pool's mutation epoch; and the host
tier (park the coldest session instead of preempting it, resume through
the prefetcher or, when it is dead, synchronously) invisible in the
tokens. JAX outputs are computed once per module from the same numpy
params."""
import numpy as np
import pytest

from paddle_tpu.inference.decode import DecodeEngine as JaxEngine
from paddle_tpu.inference.decode import DecodeModelConfig as JaxConfig
from paddle_tpu.inference.decode import init_decode_params as jax_init
from paddle_tpu.inference.decode import reference_generate as jax_ref
from paddle_tpu.inference.decode.kv_cache import HostKVPool as JaxHostKVPool
from paddle_tpu_torch.inference import KVRestoreError
from paddle_tpu_torch.inference.decode import (DecodeEngine,
                                               DecodeModelConfig,
                                               HostKVPool, NgramProposer,
                                               PageTableManager)

JCFG = JaxConfig(vocab_size=32, n_layers=2, n_heads=2, head_dim=8,
                 ffn_dim=32, max_context=64)
CFG = DecodeModelConfig(**JCFG.to_dict())
GEOM = dict(max_batch=3, n_pages=32, page_size=8, max_pages_per_seq=8)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11, 12]]


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
def oracle(jparams):
    """The dense greedy oracle's outputs, memoised by (prompt, n)."""
    memo = {}

    def get(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = jax_ref(JCFG, jparams, prompt, n)
        return memo[key]

    return get


@pytest.fixture(scope="module")
def jax_engine_outputs(jparams):
    """The JAX engine (its async tick, the default) over PROMPTS, for
    the f32 and the int8 pool."""
    out = {}
    for codec in ("off", "int8"):
        eng = JaxEngine(JCFG, params=jparams, kv_codec=codec, **GEOM)
        out[codec] = _serve(eng, PROMPTS, 7)
    return out


def _engine(np_params, async_decode=None, **kw):
    args = dict(GEOM)
    args.update(kw)
    eng = DecodeEngine(CFG, params=np_params, device="cpu",
                       async_decode=async_decode, **args)
    eng.warm()
    return eng


# ---------------------------------------------------------------------------
# mode gating
# ---------------------------------------------------------------------------
def test_async_mode_gating(np_params):
    geo = dict(device="cpu", page_size=8, max_pages_per_seq=8)
    assert DecodeEngine(CFG, params=np_params, **geo)._async_decode is True
    assert DecodeEngine(CFG, params=np_params, async_decode=False,
                        **geo)._async_decode is False
    # sampling keeps the synchronous tick, and cannot ask for the async
    assert DecodeEngine(CFG, params=np_params, temperature=0.7,
                        **geo)._async_decode is False
    with pytest.raises(ValueError, match="greedy"):
        DecodeEngine(CFG, params=np_params, temperature=0.7,
                     async_decode=True, **geo)
    # spec engines verify synchronously unless asked otherwise
    assert DecodeEngine(CFG, params=np_params, spec_k=2,
                        **geo)._async_decode is False


# ---------------------------------------------------------------------------
# parity matrix: async against the oracle, the JAX engine and the sync twin
# ---------------------------------------------------------------------------
def test_async_mixed_lengths_bitwise_oracle(np_params, oracle,
                                            jax_engine_outputs):
    eng = _engine(np_params)
    assert eng._async_decode
    out = _serve(eng, PROMPTS, 7)
    assert out == [oracle(p, 7) for p in PROMPTS]
    assert out == jax_engine_outputs["off"]
    # the pipeline really ran lagged: the phases published the overlap
    # gauge, and the lagged tick was consumed
    assert eng._inflight is None
    assert 0.0 < eng.counters["decode_overlap_frac"] <= 1.0
    phases = eng.tick_phase_totals()
    assert set(phases) == {"dispatch", "host", "fetch"}
    assert all(v >= 0 for v in phases.values())


@pytest.mark.parametrize("codec", ["off", "int8"])
def test_async_and_sync_ticks_are_bitwise(np_params, jax_engine_outputs,
                                          codec):
    outs = {mode: _serve(_engine(np_params, async_decode=mode,
                                 kv_codec=codec), PROMPTS, 7)
            for mode in (True, False)}
    assert outs[True] == outs[False] == jax_engine_outputs[codec]


def test_async_continuous_arrival_joins_running_batch(np_params, oracle):
    eng = _engine(np_params)
    h1 = eng.submit([7, 3, 1, 2], max_new_tokens=10)
    for _ in range(4):
        eng.run_once()
    assert not h1.done()
    h2 = eng.submit([9, 8], max_new_tokens=5)
    _drive(eng)
    assert h1.result(timeout=5) == oracle([7, 3, 1, 2], 10)
    assert h2.result(timeout=5) == oracle([9, 8], 5)


def test_async_budget_stop_discards_speculative_extra(np_params, oracle):
    """The budget is known at dispatch, so no tick runs past it: outputs
    are EXACTLY max_new_tokens long, and nothing is left in flight."""
    eng = _engine(np_params)
    for n in (1, 2, 3, 5):
        h = eng.submit([5, 4, 3], max_new_tokens=n)
        _drive(eng)
        out = h.result(timeout=5)
        assert len(out) == n
        assert out == oracle([5, 4, 3], n)
    assert eng._inflight is None


def test_async_eos_discards_the_token_in_flight(np_params, oracle):
    """EOS shows only at the lagged harvest, when the next tick is
    already in flight: its token is discarded, the output ends at EOS as
    the sync tick's does, and stop() consumes the tick left over."""
    ref = oracle([4, 5, 6, 7, 8, 9, 10], 6)
    outs = {}
    for mode in (True, False):
        eng = _engine(np_params, async_decode=mode, eos_id=ref[2])
        outs[mode] = _serve(eng, [[4, 5, 6, 7, 8, 9, 10]], 6)[0]
        eng.stop()
        assert eng._inflight is None
    assert outs[True] == outs[False] == ref[:3]


def test_async_preemption_under_pool_pressure():
    """No host tier: pool pressure preempts mid-pipeline (the in-flight
    tick drains first) and outputs stay the oracle's."""
    jcfg = JaxConfig(vocab_size=32, n_layers=1, n_heads=2, head_dim=8,
                     ffn_dim=16, max_context=24)
    jp = jax_init(jcfg, 7)
    eng = DecodeEngine(DecodeModelConfig(**jcfg.to_dict()),
                       params={k: np.asarray(v) for k, v in jp.items()},
                       max_batch=2, n_pages=8, page_size=4,
                       max_pages_per_seq=6, device="cpu")
    assert eng._async_decode
    eng.warm()
    prompts = [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10, 11]]
    assert _serve(eng, prompts, 10) == \
        [jax_ref(jcfg, jp, p, 10) for p in prompts]
    assert eng.counters["decode_preempted"] >= 1
    assert eng.pool.pages_in_use == 0


def test_async_spec_compose_parity(np_params, oracle):
    """A spec engine asked for the async tick keeps its own verify tick;
    the composition stays exact."""
    eng = _engine(np_params, async_decode=True, spec_k=3,
                  proposer=NgramProposer())
    loop_prompt = [1, 2, 3, 1, 2, 3, 1, 2]
    assert _serve(eng, [loop_prompt], 10)[0] == oracle(loop_prompt, 10)


# ---------------------------------------------------------------------------
# steady ticks: nothing uploaded while the tables stand still
# ---------------------------------------------------------------------------
def test_mutation_epoch_bumped_by_every_mutator():
    pool = PageTableManager(n_pages=8, page_size=4, max_pages_per_seq=4)
    m0 = pool.mutations
    pool.alloc_seq(1, 6)
    assert pool.mutations > m0
    m1 = pool.mutations
    assert pool.append_token(1, 7) is None     # within tail page
    assert pool.mutations == m1                # no table change: no bump
    assert pool.append_token(1, 9) not in (None, -1)   # page boundary
    assert pool.mutations > m1
    m2 = pool.mutations
    pool.free_seq(1)
    assert pool.mutations > m2


def test_async_page_boundary_growth_stays_exact(np_params, oracle):
    """Generations that cross page boundaries mid-stream change the
    steady signature (the table mutates) and re-upload the control
    vectors without losing exactness; between boundaries the ticks are
    steady and upload nothing."""
    eng = _engine(np_params, page_size=4, n_pages=32, max_pages_per_seq=8)
    uploads = []
    real = eng._upload
    eng._upload = lambda *a: uploads.append(len(a)) or real(*a)
    m0 = eng.pool.mutations
    assert _serve(eng, [[1, 2, 3]], 12)[0] == oracle([1, 2, 3], 12)
    assert eng.pool.mutations > m0
    ticks = eng.counters["decode_steps"]
    assert 0 < len(uploads) < ticks     # rebuild ticks only


# ---------------------------------------------------------------------------
# the host KV tier
# ---------------------------------------------------------------------------
def _record(seed):
    rng = np.random.RandomState(seed)
    kq = rng.randint(-128, 127, (2, 4, 2, 8)).astype(np.int8)
    ks = rng.rand(2, 4).astype(np.float32)
    return kq, ks, kq.copy(), ks.copy()


def test_host_kv_pool_roundtrip_and_capacity_match_jax():
    pools = [cls(n_layers=2, page_size=4, heads=2, head_dim=8,
                 capacity_bytes=8 * 1024)
             for cls in (HostKVPool, JaxHostKVPool)]
    ours, theirs = pools
    assert ours.page_nbytes == theirs.page_nbytes
    records = [_record(0), _record(1)]
    for host in pools:
        assert host.put_seq(7, records)
        assert host.pages_host == 2
    popped = ours.pop_seq(7)
    theirs.pop_seq(7)
    assert len(popped) == 2 and ours.pages_host == 0
    for a, b in zip(records, popped):       # verbatim int8 rows
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    # the capacity accounting refuses what cannot fit, as JAX's does
    for n in (1, 3, 10, 10 ** 6):
        assert ours.room_for(n) == theirs.room_for(n)
    assert not ours.room_for(10 ** 6)
    # prefix spill is keyed and one-shot; pages age out LRU-first
    for host in pools:
        for i in range(30):     # 25 pages of 320 bytes fit
            host.put_prefix(b"k%d" % i, _record(2 + i))
    assert ours.snapshot() == theirs.snapshot()
    assert ours.pages_host == 25
    assert ours.take_prefix(b"k29") is not None
    assert ours.take_prefix(b"k29") is None
    assert ours.take_prefix(b"k0") is None      # aged out


def _offload_workload():
    plens = (9, 11, 9, 11, 9, 11)
    prompts = []
    for i in range(6):
        rng = np.random.RandomState(3000 + i)
        prompts.append([int(t) for t in rng.randint(0, CFG.vocab_size,
                                                    plens[i])])
    return prompts, 9


TIGHT = dict(max_batch=3, n_pages=9, page_size=4, max_pages_per_seq=5)
ROOMY = dict(max_batch=3, n_pages=32, page_size=4, max_pages_per_seq=5)


@pytest.fixture(scope="module")
def big_pool_outputs(np_params):
    """The big-pool twin's tokens, one request at a time, per codec."""
    prompts, new = _offload_workload()
    out = {}
    for codec in ("off", "int8"):
        ref = _engine(np_params, kv_codec=codec, **ROOMY)
        out[codec] = [_serve(ref, [p], new)[0] for p in prompts]
    return out


@pytest.mark.parametrize("codec", ["off", "int8"])
def test_park_resume_roundtrip_matches_big_pool_oracle(np_params, codec,
                                                       big_pool_outputs):
    """More concurrent sessions than the pool holds: the engine parks
    the coldest session into the host tier and resumes it with its KV
    restored; the tokens equal a big-pool twin's (int8 pools park
    verbatim, so that is bitwise by construction)."""
    prompts, new = _offload_workload()
    eng = _engine(np_params, kv_codec=codec, host_kv_bytes=1 << 20,
                  **TIGHT)
    assert _serve(eng, prompts, new) == big_pool_outputs[codec]
    c = eng.counters
    assert c.get("kv_sessions_parked", 0) >= 1
    assert c.get("kv_sessions_resumed", 0) >= 1
    assert c.get("kv_page_restores", 0) >= 1
    assert c.get("kv_offload_bytes", 0) > 0
    assert c.get("kv_restore_fallbacks", 0) == 0
    assert c["kv_pages_parked"] >= 1 and "kv_pages_host" in c
    snap = eng.kv_debug_snapshot()
    assert snap["async_decode"] is True
    assert snap["host_tier"]["spilled_pages"] >= 1
    assert eng.engine_latency_stats()["restore_wait_p99_ms"] >= 0


def test_dry_pool_parks_with_tier_preempts_without(np_params,
                                                   big_pool_outputs):
    """Same dry-pool workload twice: the tier-less engine can only
    preempt; the tiered engine parks instead; both give the big-pool
    twin's tokens."""
    prompts, new = _offload_workload()
    outs = {}
    for tier in (0, 1 << 20):
        eng = _engine(np_params, host_kv_bytes=tier, **TIGHT)
        outs[tier] = _serve(eng, prompts, new)
        if tier:
            assert eng.counters.get("kv_sessions_parked", 0) >= 1
        else:
            assert eng.counters.get("kv_sessions_parked", 0) == 0
            assert eng.counters.get("decode_preempted", 0) >= 1
    assert outs[0] == outs[1 << 20] == big_pool_outputs["off"]


def test_killed_prefetch_falls_back_to_sync_restore(monkeypatch, np_params,
                                                    big_pool_outputs):
    """A dead restore prefetcher surfaces as KVRestoreError; the resume
    restores synchronously, counts the fallback, and the tokens are
    unaffected."""
    prompts, new = _offload_workload()
    eng = _engine(np_params, host_kv_bytes=1 << 20, **TIGHT)

    def dead_take(key):
        raise KVRestoreError("prefetch worker died")

    monkeypatch.setattr(eng._prefetch, "take", dead_take)
    assert _serve(eng, prompts, new) == big_pool_outputs["off"]
    assert eng.counters.get("kv_restore_fallbacks", 0) >= 1
