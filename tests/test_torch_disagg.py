"""Prefill/decode disaggregation in the port (paddle_tpu_torch.ps.codec's
numpy wire codecs, serving.disagg, fault.retry and
DecodeEngine.adopt_pages, on device="cpu") against the JAX package:
the codecs and page frames byte for byte in both directions, the typed
rejects, the ship-vs-recompute closed form, the migration client's
degrade leg, and a JAX-made frame adopted by both engines giving the
same tokens."""
import numpy as np
import pytest

from paddle_tpu.inference.decode import DecodeEngine as JaxEngine
from paddle_tpu.inference.decode import DecodeModelConfig as JaxConfig
from paddle_tpu.inference.decode import init_decode_params as jax_init
from paddle_tpu.ps import codec as jcodec
from paddle_tpu.serving import disagg as jdisagg
from paddle_tpu_torch import profiler
from paddle_tpu_torch.fault import Backoff, Retrier
from paddle_tpu_torch.inference.decode import (DecodeEngine,
                                               DecodeModelConfig)
from paddle_tpu_torch.inference.decode.model import (params_from_numpy,
                                                     reference_generate)
from paddle_tpu_torch.ps import codec as tcodec
from paddle_tpu_torch.serving import (MalformedPageFrame, MigrationClient,
                                      PrefillWorker, decode_frame,
                                      encode_frame, migration_cost,
                                      quantize_rows)

JCFG = JaxConfig(vocab_size=32, n_layers=2, n_heads=2, head_dim=8,
                 ffn_dim=32, max_context=64)
CFG = DecodeModelConfig(**JCFG.to_dict())
GEOM = dict(max_batch=3, n_pages=32, page_size=8, max_pages_per_seq=8)
PROMPT = [int(t) for t in np.random.RandomState(42).randint(0, 32, 19)]


@pytest.fixture(scope="module")
def jparams():
    return jax_init(JCFG, 3)


@pytest.fixture(scope="module")
def np_params(jparams):
    return {k: np.asarray(v) for k, v in jparams.items()}


def _values(seed, n):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * rng.uniform(0.01, 30)).astype(np.float32)
    x[:: max(1, n // 7)] = 0.0
    return x


# ---------------------------------------------------------------------------
# the numpy wire codecs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("n,block", [(1, 512), (511, 512), (4096, 512),
                                     (1000, 16), (3 * 128, 128)])
def test_np_codecs_are_byte_equal_to_jax(codec, n, block):
    x = _values(n + block, n)
    raw = tcodec.np_encode(x, codec, block=block)
    assert raw == jcodec.np_encode(x, codec, block=block)
    assert len(raw) == tcodec.encoded_nbytes(n, codec, block)
    back = tcodec.np_decode(raw, n, codec, block=block)
    np.testing.assert_array_equal(
        back, jcodec.np_decode(raw, n, codec, block=block))
    assert back.dtype == np.float32 and back.shape == (n,)


def test_codec_name_and_ids_match_jax():
    for cid in (0, 1, 2):
        assert tcodec.codec_name(cid) == jcodec.codec_name(cid)
    assert tcodec.CODEC_IDS == jcodec.CODEC_IDS
    with pytest.raises(ValueError):
        tcodec.codec_name(9)
    with pytest.raises(ValueError):
        tcodec.np_encode(np.zeros(4, np.float32), "int4")


def test_quantize_rows_matches_jax():
    rows = _values(5, 3 * 4 * 2 * 8).reshape(3, 4, 2, 8)
    ours, theirs = quantize_rows(rows), jdisagg.quantize_rows(rows)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# page frames
# ---------------------------------------------------------------------------
def _kv(seed, n_layers=2, tokens=16, heads=2, head_dim=8):
    rng = np.random.RandomState(seed)
    shape = (n_layers, tokens, heads, head_dim)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("codec", ["int8", "bf16", "f32"])
def test_frames_are_byte_equal_both_ways(codec):
    tokens = list(range(1, 17))               # 2 full pages of 8
    ks, vs = _kv(1)
    ours = encode_frame(tokens, ks, vs, page_size=8, codec=codec)
    theirs = jdisagg.encode_frame(tokens, ks, vs, page_size=8, codec=codec)
    assert ours == theirs
    for frame in (ours, theirs):
        pa, pb = decode_frame(frame), jdisagg.decode_frame(frame)
        assert (pa.codec, pa.n_layers, pa.n_pages, pa.page_size, pa.heads,
                pa.head_dim, pa.tokens) == \
            (pb.codec, pb.n_layers, pb.n_pages, pb.page_size, pb.heads,
             pb.head_dim, pb.tokens)
        for which in ("k", "v"):
            np.testing.assert_array_equal(pa.f32_rows(which),
                                          pb.f32_rows(which))
            for a, b in zip(pa.int8_rows(which), pb.int8_rows(which)):
                np.testing.assert_array_equal(a, b)


def test_frame_typed_rejects_match_jax():
    tokens = list(range(1, 17))
    frame = encode_frame(tokens, *_kv(2), page_size=8)
    bad_version = frame[:4] + bytes([9]) + frame[5:]
    bad_codec = frame[:5] + bytes([7]) + frame[6:]
    for bad in (frame[:10], b"XXXX" + frame[4:], frame + b"\x00",
                frame[:-2], bad_version, bad_codec, b""):
        with pytest.raises(MalformedPageFrame):
            decode_frame(bad)
        with pytest.raises(jdisagg.MalformedPageFrame):
            jdisagg.decode_frame(bad)
    with pytest.raises(ValueError):
        encode_frame(tokens[:12], *_kv(2, tokens=12), page_size=8)


@pytest.mark.parametrize("n_tokens", [1, 16, 2048])
@pytest.mark.parametrize("codec", ["int8", "bf16", "f32"])
def test_migration_cost_matches_jax(n_tokens, codec):
    serving = dict(vocab_size=256_000, n_layers=48, n_heads=32,
                   head_dim=128, ffn_dim=32_768, max_context=8192)
    for cfg, jcfg in ((CFG, JCFG), (DecodeModelConfig(**serving),
                                    JaxConfig(**serving))):
        assert migration_cost(cfg, n_tokens, codec) == \
            jdisagg.migration_cost(jcfg, n_tokens, codec)


def test_prefill_worker_ships_what_jax_ships(np_params, jparams):
    """The port's worker and JAX's, from the same params: the same
    header, tokens and next token; rows within one quantization step
    (the forwards sum f32 in other orders); a sub-page prompt ships
    nothing."""
    ours = PrefillWorker(CFG, params=np_params, page_size=8,
                         device="cpu").prefill(PROMPT)
    theirs = jdisagg.PrefillWorker(JCFG, params=jparams,
                                   page_size=8).prefill(PROMPT)
    assert (ours.n_pages, ours.next_token, ours.encoded_bytes,
            ours.f32_bytes) == (theirs.n_pages, theirs.next_token,
                                theirs.encoded_bytes, theirs.f32_bytes)
    assert len(ours.frame) == len(theirs.frame)
    pa, pb = decode_frame(ours.frame), jdisagg.decode_frame(theirs.frame)
    assert pa.tokens == pb.tokens == PROMPT[:16]
    for which in ("k", "v"):
        a, b = pa.f32_rows(which), pb.f32_rows(which)
        step = np.abs(b).max() / 127
        np.testing.assert_allclose(a, b, atol=step, rtol=0)
    empty = PrefillWorker(CFG, params=np_params, page_size=8,
                          device="cpu").prefill([1, 2, 3])
    assert empty.frame is None and empty.n_pages == 0


# ---------------------------------------------------------------------------
# retries and the degrade leg
# ---------------------------------------------------------------------------
def test_retrier_and_backoff():
    assert [Backoff(base=0.1, factor=2.0, cap=0.5, jitter=0.0).delay(a)
            for a in range(4)] == [0.1, 0.2, 0.4, 0.5]
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("down")
        return "up"

    before = profiler.counters_snapshot().get("retry_attempts", 0)
    r = Retrier(max_attempts=3, backoff=Backoff(jitter=0.0),
                sleep=slept.append)
    assert r.call(flaky) == "up" and slept == [0.1, 0.2]
    assert profiler.counters_snapshot()["retry_attempts"] == before + 2
    with pytest.raises(ValueError):      # not retryable: raised at once
        r.call(lambda: (_ for _ in ()).throw(ValueError("no")))
    with pytest.raises(ConnectionError):
        Retrier(max_attempts=2, sleep=lambda s: None).call(
            lambda: (_ for _ in ()).throw(ConnectionError("down")))


def test_migration_client_degrade_leg(np_params):
    def fallbacks():
        return profiler.counters_snapshot().get("kv_migration_fallbacks",
                                                0)

    worker = PrefillWorker(CFG, params=np_params, page_size=8,
                           device="cpu")
    shipment = worker.prefill(list(range(1, 17)))
    before = fallbacks()
    sends = []

    def dead_send(frame):
        sends.append(frame)
        raise ConnectionError("nothing listens there")

    rep = MigrationClient(dead_send, max_attempts=2,
                          sleep=lambda s: None).migrate(shipment)
    assert rep["ok"] is False and "ConnectionError" in rep["reason"]
    assert len(sends) == 2 and fallbacks() == before + 1
    # a malformed frame is never retried
    rep = MigrationClient(lambda f: decode_frame(b"junk"),
                          sleep=lambda s: None).migrate(shipment)
    assert rep["ok"] is False and fallbacks() == before + 2
    # a sub-page prompt has nothing to ship: a fallback, not an error
    rep = MigrationClient(dead_send).migrate(worker.prefill([1, 2, 3]))
    assert rep["ok"] is False and rep["reason"] == "no_full_pages"
    assert fallbacks() == before + 3


# ---------------------------------------------------------------------------
# adoption: a JAX-made frame into both engines
# ---------------------------------------------------------------------------
def _port_engine(np_params, **kw):
    eng = DecodeEngine(CFG, params=np_params, device="cpu", **GEOM, **kw)
    eng.warm()
    return eng


@pytest.mark.parametrize("codec", ["off", "int8"])
def test_jax_frame_adopted_by_both_engines_gives_the_same_tokens(
        np_params, jparams, codec):
    """A JAX PrefillWorker's int8 frame adopted by the JAX engine and by
    the port's: both hit the adopted prefix, prefill only the suffix,
    and emit the same tokens (the dense oracle's). An int8 pool holds
    the frame's rows and scales bit for bit."""
    shipment = jdisagg.PrefillWorker(JCFG, params=jparams,
                                     page_size=8).prefill(PROMPT)
    jeng = JaxEngine(JCFG, params=jparams, kv_codec=codec, **GEOM)
    ours = _port_engine(np_params, kv_codec=codec)
    reports = [MigrationClient(e.adopt_pages).migrate(shipment)
               for e in (jeng, ours)]
    assert reports[0] == reports[1]
    assert reports[1]["ok"] and reports[1]["adopted"] == 2
    pf = decode_frame(shipment.frame)
    pages = ours.pool.match_prefix(PROMPT)
    assert len(pages) == 2
    if codec == "int8":
        kq, ks = pf.int8_rows("k")
        np.testing.assert_array_equal(
            ours._k_pages[:, pages].numpy(), kq)
        np.testing.assert_array_equal(
            ours._k_scales[:, pages].numpy(), ks)
    outs = []
    for eng in (jeng, ours):
        hits0 = eng.pool.prefix_hits
        h = eng.submit(PROMPT, max_new_tokens=6)
        for _ in range(200):
            if not eng.sched.pending():
                break
            eng.run_once()
        outs.append(h.result(timeout=5))
        assert eng.pool.prefix_hits == hits0 + 2
    tp = params_from_numpy(np_params, device="cpu")
    assert outs[0] == outs[1] == reference_generate(CFG, tp, PROMPT, 6)
    assert ours.counters["kv_migration_pages"] == 2
    # re-shipping the same prefix shares instead of duplicating
    again = MigrationClient(ours.adopt_pages).migrate(shipment)
    assert again["ok"] and again["adopted"] == 0 and again["shared"] == 2


def test_port_frame_adopts_in_the_jax_engine(np_params, jparams):
    shipment = PrefillWorker(CFG, params=np_params, page_size=8,
                             device="cpu").prefill(PROMPT)
    jeng = JaxEngine(JCFG, params=jparams, **GEOM)
    rep = jeng.adopt_pages(shipment.frame)
    assert rep["ok"] and rep["adopted"] == 2
    assert len(jeng.pool.match_prefix(PROMPT)) == 2


def test_adoption_on_a_running_engine_and_geometry_reject(np_params):
    """While the scheduler thread runs, a frame is queued and adopted
    between ticks; a frame of another geometry or no frame at all is a
    typed reject."""
    eng = _port_engine(np_params)
    eng.start()
    try:
        frame = encode_frame(list(range(1, 17)), *_kv(3), page_size=8)
        rep = eng.adopt_pages(frame)
        assert rep["ok"] and rep["adopted"] == 2
        other = encode_frame(list(range(1, 17)),
                             *_kv(3, n_layers=1), page_size=8)
        with pytest.raises(MalformedPageFrame, match="geometry"):
            eng.adopt_pages(other)
        with pytest.raises(MalformedPageFrame):
            eng.adopt_pages(b"not a frame at all")
        assert eng.generate([5, 6, 7], max_new_tokens=3, timeout=30)
    finally:
        eng.stop()
