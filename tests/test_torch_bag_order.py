"""A model of the sum order of the embedding bag kernel's row-order
sweep (``paddle_tpu_torch/ops/cuda/csrc/fused_embedding.cu``
``bag_sweep_kernel``, the form large f32 tables take), run on the CPU: a bag's ids staged ``kStageIds``
at a time, each staged run's rows taken in ascending row order and
added into the bag's f32 accumulator one row at a time; ids < 0 dropped
and not counted, ids >= V read as row V - 1 and counted; then the
count's pooling and the cast. Held against JAX's ``_xla_bag`` (the
definition of the TPU kernel) and the port's plain version for sum,
mean and sqrtn over an f32 and a bf16 table, with the kernel's stage
and with runs of 4 and 1 ids (a bag longer than the stage): f32 within
atol 1e-5 + rtol 1e-5 (sums in another order), bf16 within one bf16 ulp
(every form sums in f32 and rounds once).

The ascending order inside a run is what the kernel's bitonic sort
gives whatever order equal rows end in (they are equal values). A bag
of padding pools to 0, and a bag whose ids all lie at or past V to its
count times row V - 1, at every stage length.

The kernel itself runs on the card only (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused_embedding as jfe
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.ops.cuda import fused_embedding as tfe

ATOL = RTOL = 1e-5
COMBINERS = ("sum", "mean", "sqrtn")
SRC = Path(tfe.__file__).parent / "csrc" / "fused_embedding.cu"
STAGE = int(re.search(r"constexpr int kStageIds = (\d+);",
                      SRC.read_text()).group(1))


@pytest.fixture(autouse=True)
def no_launch():
    counters.reset()
    yield
    assert counters.snapshot() == {}                  # the CPU runs plain


def model_bag(table, ids, combiner, stage=STAGE):
    """The kernel's arithmetic in its order: (B, D) in the table's type."""
    V = table.shape[0]
    rows = torch.where(ids < 0, torch.full_like(ids, -1),
                       ids.clamp(max=V - 1)).long()
    t32 = table.float()
    out = torch.zeros(ids.shape[0], table.shape[1], dtype=torch.float32)
    for b in range(ids.shape[0]):
        acc = torch.zeros(table.shape[1], dtype=torch.float32)
        for s0 in range(0, ids.shape[1], stage):
            run = rows[b, s0:s0 + stage].tolist()
            for r in sorted(x for x in run if x >= 0):
                acc = acc + t32[r]
        cnt = torch.tensor(float(max(int((ids[b] >= 0).sum()), 1)))
        if combiner == "mean":
            acc = acc / cnt
        elif combiner == "sqrtn":
            acc = acc / torch.sqrt(cnt)
        out[b] = acc
    return out.to(table.dtype)


def _bf16_ulp(x):
    """One bf16 ulp at each element's magnitude (8 significant bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.where(x == 0, 2.0 ** -133, np.ldexp(1.0, e - 8))


def _data(dtype, b=6, s=14, v=37, d=24, seed=3):
    """A (v, d) table and (b, s) int64 ids in [-v/3, 4v/3): negatives are
    padding, ids >= v read row v - 1; bag 0 is all padding, bag 1 names
    one row three times."""
    rng = np.random.RandomState(seed)
    table = torch.from_numpy(rng.randn(v, d).astype(np.float32)).to(dtype)
    ids = torch.from_numpy(rng.randint(-(v // 3), v + v // 3, (b, s)))
    ids[0] = -1
    ids[1, :3] = 5
    return table, ids


def _close(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()


STAGES = [STAGE, 4, 1]


@pytest.mark.parametrize("stage", STAGES, ids=["stage", "runs4", "runs1"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("combiner", COMBINERS)
def test_model_matches_xla_bag_and_the_plain_version(combiner, dtype,
                                                     stage):
    table, ids = _data(dtype)
    got = model_bag(table, ids, combiner, stage)
    assert got.dtype == dtype and got.shape == (ids.shape[0],
                                                table.shape[1])
    assert (got[0] == 0).all()
    jt = jnp.asarray(table.float().numpy())
    if dtype == torch.bfloat16:
        jt = jt.astype(jnp.bfloat16)
    want = jfe._xla_bag(jt, jnp.asarray(ids.numpy()), combiner)
    _close(got, np.asarray(want.astype(jnp.float32)), dtype)
    _close(got, tfe._plain_bag(table, ids, combiner).float().numpy(), dtype)


@pytest.mark.parametrize("combiner", COMBINERS)
def test_a_staged_bag_sums_in_ascending_rows(combiner):
    """Ids staged at once: the bag's rows in ascending order whatever
    their positions, so a permutation of each bag gives the same bits;
    staged 4 at a time the order is run by run, and the sums stay within
    the f32 tolerance of the plain version."""
    table, ids = _data(torch.float32)
    one = model_bag(table, ids, combiner)
    perm = torch.from_numpy(np.random.RandomState(5).permutation(
        ids.shape[1]))
    assert torch.equal(model_bag(table, ids[:, perm], combiner), one)
    want = tfe._plain_bag(table, ids, combiner).numpy()
    _close(model_bag(table, ids, combiner, stage=4), want, torch.float32)


@pytest.mark.parametrize("stage", STAGES, ids=["stage", "runs4", "runs1"])
@pytest.mark.parametrize("combiner", COMBINERS)
def test_model_pools_padding_and_ids_past_the_table(combiner, stage):
    table, _ = _data(torch.float32)
    V = table.shape[0]
    ids = torch.tensor([[-1, -V - 1, -3, -1],
                        [V, V + 5, 2 * V, V - 1]])
    got = model_bag(table, ids, combiner, stage)
    assert (got[0] == 0).all()
    last = table[V - 1]
    want = {"sum": last * 4, "mean": last * 4 / 4.0,
            "sqrtn": last * 4 / 2.0}[combiner]
    torch.testing.assert_close(got[1], want, rtol=RTOL, atol=ATOL)
    _close(got, tfe._plain_bag(table, ids, combiner).numpy(), torch.float32)
