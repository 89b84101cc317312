"""The port's decode cost gauges and 2-byte pools (paddle_tpu_torch
static.cost_model.paged_decode_cost, observability.device_peaks,
labelled histograms, DecodeEngine(dtype=...)) against the JAX package,
on the CPU: the closed form number for number, the gauges an engine
publishes equal to the JAX engine's after the same workload, and
bf16/f16-pool engines token for token against JAX's engines of the same
dtype."""
import numpy as np
import pytest
import torch

from paddle_tpu.inference.decode import DecodeEngine as JaxEngine
from paddle_tpu.inference.decode import DecodeModelConfig as JaxConfig
from paddle_tpu.inference.decode import init_decode_params as jax_init
from paddle_tpu.static.cost_model import \
    paged_decode_cost as jax_paged_decode_cost
from paddle_tpu_torch.inference.decode import (DecodeEngine,
                                               DecodeModelConfig)
from paddle_tpu_torch.observability.device_peaks import peaks_for
from paddle_tpu_torch.observability.metrics import (MetricsRegistry,
                                                    default_registry)
from paddle_tpu_torch.static.cost_model import paged_decode_cost

JCFG = JaxConfig(vocab_size=32, n_layers=2, n_heads=2, head_dim=8,
                 ffn_dim=32, max_context=64)
CFG = DecodeModelConfig(**JCFG.to_dict())
GEOM = dict(max_batch=3, n_pages=32, page_size=8, max_pages_per_seq=8)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8, 9, 10], [11, 12]]
GAUGES = ("step_model_flops", "step_hbm_bytes", "step_comm_bytes",
          "arith_intensity")


def _serve(eng, prompts, max_new):
    hs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    for _ in range(800):
        if not eng.sched.pending():
            break
        eng.run_once()
    return [h.result(timeout=5) for h in hs]


@pytest.fixture(scope="module")
def jparams():
    return jax_init(JCFG, 3)


@pytest.fixture(scope="module")
def np_params(jparams):
    return {k: np.asarray(v) for k, v in jparams.items()}


@pytest.mark.parametrize("codec,itemsize", [("off", 4), ("off", 2),
                                            ("int8", 4)])
@pytest.mark.parametrize("lens", [[1], [17, 3, 64], [2047, 1500, 300, 1]])
def test_paged_decode_cost_matches_jax(codec, itemsize, lens):
    full = dict(vocab_size=32000, n_layers=24, n_heads=16, head_dim=128,
                ffn_dim=8192, max_context=2048)
    for cfg, jcfg, page in ((CFG, JCFG, 8),
                            (DecodeModelConfig(**full), JaxConfig(**full),
                             128)):
        assert paged_decode_cost(cfg, lens, page, itemsize=itemsize,
                                 kv_codec=codec) == \
            jax_paged_decode_cost(jcfg, lens, page, itemsize=itemsize,
                                  kv_codec=codec)


def test_device_peaks_hold_the_h100_data_sheet_row_only():
    p = peaks_for("NVIDIA H100 80GB HBM3")
    assert p.flops == 989e12 and p.hbm_bytes_per_s == 3.35e12
    assert peaks_for("cpu") is None and peaks_for("") is None


def test_labelled_histograms():
    reg = MetricsRegistry()
    h = reg.histogram("tick_ms", labels=("phase",))
    h.observe(3.0, phase="fetch")
    h.observe(30.0, phase="host")
    assert h.snapshot(phase="fetch")["count"] == 1
    assert h.snapshot(phase="dispatch")["count"] == 0
    assert h.percentile(50, phase="host") == pytest.approx(37.5)
    with pytest.raises(ValueError):
        h.observe(1.0)                 # the label is missing
    with pytest.raises(ValueError):
        reg.histogram("tick_ms")       # declared with labels
    assert reg.histogram("tick_ms", labels=("phase",)) is h


@pytest.mark.parametrize("async_decode", [True, False])
def test_engine_gauges_equal_the_jax_engines(np_params, jparams,
                                             monkeypatch, async_decode):
    """The same workload through both engines (each its async or its
    sync tick): the last step's cost gauges are equal; mfu is 0 on a
    device without peaks; the tick phase histogram has its three
    series."""
    monkeypatch.setenv("PADDLE_ASYNC_DECODE", "1" if async_decode else "0")
    jeng = JaxEngine(JCFG, params=jparams, **GEOM)
    ours = DecodeEngine(CFG, params=np_params, device="cpu",
                        async_decode=async_decode, **GEOM)
    ours.warm()
    assert _serve(ours, PROMPTS, 6) == _serve(jeng, PROMPTS, 6)
    jc, c = jeng.counters, ours.counters
    for name in GAUGES:
        assert c[name] == jc[name], name
    assert c["step_model_flops"] > 0 and c["mfu"] == 0
    hist = default_registry().histogram("decode_tick_phase_ms",
                                        labels=("phase",))
    for phase in ("dispatch", "host", "fetch"):
        assert hist.snapshot(phase=phase)["count"] > 0
    frac = c["decode_overlap_frac"]
    assert (0.0 < frac <= 1.0) if async_decode else (0.0 <= frac < 1.0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_2_byte_pool_engine_matches_the_jax_engine(np_params, jparams,
                                                   dtype):
    """``dtype="bfloat16"``/``"float16"``: the pool is 2-byte, params
    stay f32 (as in the reference), and greedy tokens equal the JAX
    engine's of the same dtype; the async and sync ticks agree."""
    jeng = JaxEngine(JCFG, params=jparams, dtype=dtype, **GEOM)
    theirs = _serve(jeng, PROMPTS, 8)
    for mode in (True, False):
        eng = DecodeEngine(CFG, params=np_params, device="cpu",
                           dtype=dtype, async_decode=mode, **GEOM)
        eng.warm()
        assert eng._k_pages.dtype == getattr(torch, dtype)
        assert eng.params["l0.wq"].dtype == torch.float32
        assert _serve(eng, PROMPTS, 8) == theirs


def test_other_dtypes_raise(np_params):
    with pytest.raises(ValueError, match="dtype"):
        DecodeEngine(CFG, params=np_params, device="cpu", dtype="int8",
                     **GEOM)
