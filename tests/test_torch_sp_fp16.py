"""Sequence parallelism at AMP O1 fp16 (GPT-2 over {"sp": 2} at O1 fp16 on
the card): the external-lse K1b over f16, the port's ring over f16 and
the GPT's dp x sp step at O1 fp16, held against the JAX package on the
CPU from the same numpy inputs.

- ``flash_attention_bwd_ext``'s plain version over f16 against JAX
  ``_bwd_call`` over f16 in interpret mode, for one kv chunk with the
  f32 lse and delta of a longer sequence (B 1, L 128, H 2, D 64; causal
  and not; dO at 2^15 / L and at 1 / L): both compute in f32 and write
  f16, so each output within one f16 unit at its magnitude plus 1e-5 of
  the largest value.
- One 4-rank gloo spawn (``distributed.spawn``, ``file://`` rendezvous
  under ``tmp_path``) that runs both multi-rank checks:
  - the port's global ``ring_attention`` over f16 on ``create_mesh(
    {"sp": 4})`` (B 1, L 512, H 2, D 64: 128 rows a rank, the JAX flash
    ring's smallest block; causal and full), forward and the gradients
    of sum(w * out), against JAX ``ring_attention`` over f16 on its
    ``{"sp": 4}`` mesh with the flash ring forced on in interpret mode
    (``_ring_flash``: per block ``_fwd_call`` and ``_bwd_call`` over f16,
    the blocks' outputs summed in f32 and cast once, as the port's walk
    does), element by element by the card's 2-byte rule for the ring
    (``chip_smoke.flash_2byte_vs_plain`` with ``form="ring"``): one f16
    unit plus four f16 unit roundoffs of the 2-norm of the element's
    terms, the f32 sums' allowance, 1e-6 of the largest value, and, as
    each of the 4 blocks' outputs is rounded to f16 in both rings, 4
    units of f16 at the bound of a block partial (two half units a
    block: ``chip_smoke.ring_block_bounds``). A block partial exceeds the
    sum where the blocks cancel, so a count of units at the sum's own
    magnitude does not bound it;
  - ``GPTConfig.tiny()`` (weights carried from JAX by
    ``load_numpy_state``, dropout 0), batch 4 x 64, AdamW lr 1e-3 wd
    0.01, three ``TrainStep`` steps at O1 fp16 over ``create_mesh({"dp":
    2, "sp": 2})`` (``data_spec=PartitionSpec("dp", "sp")``,
    ``sequence_parallel="sp"``): every rank's losses against JAX's
    single-device ``TrainStep`` at O1 fp16, rtol 5e-3 (the NMT's O1 fp16
    tolerance, ``tests/test_torch_nmt.py``: f16 GEMMs summed in other
    orders and shapes), and every rank the same losses bit for bit.
- The port's single-process ``TrainStep`` at O1 fp16 against JAX's, the
  same tolerance; its attention receives f16 q, k and v.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sp_ranks as ranks
import paddle_tpu as paddle
import paddle_tpu.framework.bringup as bringup
import paddle_tpu.parallel.ring as jring_mod
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.ops.pallas import counters as jcounters
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.parallel import ring as jring
from paddle_tpu_torch.distributed import spawn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import (GPTConfig, GPTForCausalLM,
                                         load_numpy_state)
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.optimizer import AdamW

B, L, STEPS, LR = 4, 64, 3, 1e-3
FP16_RTOL = 5e-3


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run pallas_call in interpret mode so the JAX kernels run on CPU."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(real, interpret=True))


def _units(got, want, n_units):
    """The largest |got - want| over n_units f16 units at the element's
    magnitude plus 1e-5 of the largest |want|: <= 1 passes."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    big = np.maximum(np.abs(got), np.abs(want)).astype(np.float16)
    unit = (np.nextafter(big, np.float16(np.inf)) - big).astype(np.float32)
    allow = n_units * unit + 1e-5 * float(np.abs(want).max())
    return float((np.abs(got - want) / allow).max())


def _heads(x):
    b, l, h, d = x.shape
    return jnp.asarray(np.swapaxes(x, 1, 2).reshape(b * h, l, d))


@pytest.mark.parametrize("scale", [2.0 ** 15, 1.0], ids=["scale2^15",
                                                         "scale1"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_f16_ext_backward_plain_matches_pallas_bwd_call(interpret_pallas,
                                                        causal, scale):
    rng = np.random.RandomState(4)
    Bq, Lq, H, D = 1, 128, 2, 64
    q, k, v, k2, v2 = (rng.randn(Bq, Lq, H, D).astype(np.float16)
                       for _ in range(5))
    do = (rng.randn(Bq, Lq, H, D) * scale / Lq).astype(np.float16)
    t = torch.tensor
    out, lse = tfa._plain_fwd(t(q).float(),
                              t(np.concatenate([k2, k], 1)).float(),
                              t(np.concatenate([v2, v], 1)).float(),
                              False, 0.0, 0)
    out = out.half()
    delta = (t(do).float() * out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(Bq * H, Lq).contiguous()
    grads = tfa.flash_attention_bwd_ext(t(q), t(k), t(v), t(do), lse, delta,
                                        causal)
    jgrads = jfa._bwd_call(
        _heads(q), _heads(k), _heads(v), _heads(do),
        jnp.asarray(lse.numpy())[:, None, :],
        jnp.asarray(delta.numpy())[:, None, :], causal, 128, 128,
        1.0 / np.sqrt(D), heads=H)
    for got, want in zip(grads, jgrads):
        assert got.dtype == torch.float16 and want.dtype == jnp.float16
        want = np.swapaxes(np.asarray(want).reshape(Bq, H, Lq, D), 1, 2)
        assert _units(got.numpy(), want, 1) <= 1.0
    assert counters.snapshot().get("flash_attention_ext_bwd_f16", 0) == 0


RING_L = 512


def _ring_case(name, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(1, RING_L, 2, 64).astype(np.float16)
               for _ in range(3))
    w = (rng.randn(1, RING_L, 2, 64) / RING_L).astype(np.float16)
    return name, q, k, v, w, name == "causal", None


RING_CASES = ["causal", "full"]


def _jax_model():
    paddle.seed(0)
    jm = JGPT(JGPTConfig.tiny())
    return jm, {k: v.numpy() for k, v in jm.state_dict().items()}


def _ids(seed=0):
    return np.random.RandomState(seed).randint(0, 128, (B, L)) \
        .astype(np.int64)


def _jax_fp16_losses():
    jm, _ = _jax_model()

    def loss(m, x):
        with jamp.auto_cast(level="O1", dtype="float16"):
            return m.loss(x)

    step = JTrainStep(jm, loss, jopt.AdamW(learning_rate=LR,
                                           parameters=jm.parameters(),
                                           weight_decay=0.01))
    ids = paddle.to_tensor(_ids())
    return np.array([float(step(ids).numpy()) for _ in range(STEPS)])


@pytest.fixture(scope="module")
def sp4(tmp_path_factory):
    """One 4-rank gloo run of the f16 ring cases and the O1 fp16 dp x sp
    GPT steps; JAX's single-device O1 fp16 losses."""
    _, state = _jax_model()
    cases = [_ring_case(name, 40 + i) for i, name in enumerate(RING_CASES)]
    path = tmp_path_factory.mktemp("sp_fp16") / "rendezvous"
    got = spawn(ranks.sp_fp16_rank,
                args=(cases, GPTConfig.tiny(), state, _ids(), STEPS, LR),
                nprocs=4, init_method=f"file://{path}", timeout=120)
    return {c[0]: c for c in cases}, got, state, _jax_fp16_losses()


@pytest.mark.parametrize("name", RING_CASES)
def test_f16_ring_4_ranks_matches_jax_flash_ring(sp4, monkeypatch, name):
    import chip_smoke as cs
    from jax.experimental import pallas as pl

    cases, got, _, _ = sp4
    _, q, k, v, w, causal, _ = cases[name]
    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(real, interpret=True))
    monkeypatch.setattr(bringup, "pallas_enabled", lambda: True)
    monkeypatch.setattr(jring_mod, "_SHARD_MAP_CHECK_VMA", [False])
    prev = jmesh.get_mesh()
    jcounters.reset()
    try:
        mesh = jmesh.create_mesh({"sp": 4})

        @jax.jit
        def f(a, b, c, cot):
            out, vjp = jax.vjp(lambda a_, b_, c_: jring.ring_attention(
                a_, b_, c_, mesh=mesh, is_causal=causal), a, b, c)
            return (out, *vjp(cot))

        want = [np.asarray(x) for x in f(*map(jnp.asarray, (q, k, v, w)))]
    finally:
        jmesh.set_mesh(prev)
    assert jcounters.snapshot().get("ring_attention.pallas", 0) >= 1
    tq, tk, tv, tw = (torch.tensor(x) for x in (q, k, v, w))
    _, lse = tfa._plain_fwd(tq.float(), tk.float(), tv.float(), causal,
                            0.0, 0)
    for rank in range(4):             # global in, global out on every rank
        out = torch.tensor(got[rank]["ring"][name][0]).half()
        norms, sums = tfa._term_norms(tq, tk, tv, out, lse, tw, causal, 0.0,
                                      0)
        floor = (0.0,) + tuple(cs.FLASH_F32_SUMS * 64 * x for x in sums) \
            + (0.0,)
        bounds = cs.ring_block_bounds(torch, tfa, tq, tk, tv, tw, lse, causal,
                                      None, sums)
        u = cs.FLASH_UNIT_ROUNDOFF["float16"]
        for x, ref, n, fl, bd in zip(got[rank]["ring"][name], want, norms,
                                     floor, bounds):
            assert ref.dtype == np.float16
            ref = torch.tensor(ref.astype(np.float32))
            extra = cs.FLASH_TERMS_K * u * n + fl \
                + 4 * cs.unit_of(torch, bd, torch.float16) \
                + 1e-6 * float(ref.abs().max())
            assert cs.tolerance_ratio(torch, torch.tensor(x).half(), ref,
                                      extra) <= 1.0
    assert got[0]["ring"]["launches"] == {}        # the CPU runs plain


def test_dp_sp_losses_at_o1_fp16_match_jax_single_device(sp4):
    _, got, _, jl = sp4
    for rank in range(4):
        np.testing.assert_allclose(got[rank]["gpt"]["losses"], jl,
                                   rtol=FP16_RTOL)
        assert got[rank]["gpt"]["losses"] == got[0]["gpt"]["losses"]
    assert got[0]["gpt"]["launches"] == {}


def test_single_process_o1_fp16_losses_match_jax(sp4, monkeypatch):
    _, _, state, jl = sp4
    tm = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    load_numpy_state(tm, state)
    seen = []
    # attention's shape route: the flash wrapper, or plain_attention at
    # the tiny GPT's head width (8)
    for name in ("flash_attention", "plain_attention"):
        monkeypatch.setattr(tfa, name, (lambda real: lambda q, *a, **kw:
                                        seen.append(q.dtype)
                                        or real(q, *a, **kw))(
            getattr(tfa, name)))
    step = TrainStep(tm, ranks.o1_fp16_loss,
                     AdamW(learning_rate=LR, parameters=tm.parameters(),
                           weight_decay=0.01))
    ids = torch.from_numpy(_ids())
    tl = [float(step(ids)) for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, rtol=FP16_RTOL)
    assert seen == [torch.float16] * (2 * STEPS)
