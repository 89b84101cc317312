"""The port's op library against the JAX package: ``ops/linalg.py``,
``ops/search.py``, ``ops/debug.py``, the ``paddle.tensor`` namespace and
the random ops.

Each op of ``ops/linalg.py``, ``ops/search.py``, ``ops/debug.py`` and
the v1.8 spellings of ``paddle.tensor`` runs in the JAX package and in
``paddle_tpu_torch`` from the same seeded numpy inputs
(``tests/_torch_op_cases.py``): the outputs, and for a differentiable op
the gradients of ``sum(out * cot)`` with a seeded random cotangent, are
held to the case's tolerance class (``_torch_op_cases.TOL``): ``exact``
for integer, boolean, layout and index ops; 1e-6 relative for
elementwise float32 (``elem``); 1e-5 relative for reductions, scans,
special functions and linear algebra (``red``), the
eigendecompositions included, each relative to the output's largest
value. A dtype differs only where JAX's 32-bit mode
narrowed the type the op asks for (int64 to int32, ...): those cases are
exactly the ones in ``NARROWED`` (ROADMAP queue 3's dtype rule).
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu.tensor  # noqa: F401  (the v1.8 spellings)
import paddle_tpu_torch as tp
from paddle_tpu_torch._device import set_default_device

import _torch_op_cases as C

CASES = C.cases("linalg", "search", "debug", "tensor")
NARROWED = {
    "argmax",
    "argmax_flat",
    "argmin",
    "argsort",
    "bincount",
    "bucketize",
    "ctc_greedy_decoder",
    "edit_distance",
    "gather_tree",
    "kthvalue",
    "mode",
    "searchsorted",
    "tensor.elementwise_floordiv",
    "tensor.numel",
    "top_k",
    "topk",
}


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield
    set_default_device(None)


@pytest.fixture(autouse=True)
def _global_rng_restored():
    """The random-op tests reseed both packages' global generators
    (``jp.seed``, ``tp.seed``); put back the state they found, so a later
    test in this process draws what it would have drawn without them.
    Left reseeded, ``tests/test_torch_static.py``'s JAX startup program
    drew another initialisation, from which its five Adam and Lamb steps
    parted from JAX's past rtol 1e-4 (``conv2d_w_0``'s moments) when
    xdist ran that file after this one on one worker."""
    from paddle_tpu.framework import random as jrandom
    from paddle_tpu_torch.framework import random as trandom

    jgen = jrandom.default_generator()
    jstate = (jgen._seed, jgen._key)
    tseed, tgens = trandom._GLOBAL["seed"], dict(trandom._GLOBAL["gens"])
    tstates = {k: g.get_state() for k, g in tgens.items()}
    yield
    jgen._seed, jgen._key = jstate
    for k, g in tgens.items():
        g.set_state(tstates[k])
    trandom._GLOBAL.update(seed=tseed, gens=tgens)


@pytest.mark.parametrize("case", CASES, ids=[c.key for c in CASES])
def test_op_matches_jax(case):
    want, want_g = C.run(jp, case)
    got, got_g = C.run(tp, case)
    narrowed = C.assert_close(got, want, case.kind, case.key)
    assert bool(narrowed) == (case.key in NARROWED), narrowed
    assert (want_g is None) == (got_g is None)
    if want_g is not None:
        C.assert_close(got_g, want_g,
                       "elem" if case.kind == "exact" else case.kind,
                       case.key + " grad")


def test_every_op_of_the_modules_has_a_case():
    """Each public op of ``paddle_tpu.ops.linalg``, ``search`` and
    ``debug`` is a case of these files or checked where
    ``_torch_op_cases.ELSEWHERE`` says."""
    names = set()
    for mod in (jp.ops.linalg, jp.ops.search, jp.ops.debug):
        names |= {n for n in getattr(mod, "__all__", dir(mod))
                   if not n.startswith("_") and callable(getattr(mod, n))
                   and getattr(getattr(mod, n), "__module__", "")
                   .startswith("paddle_tpu")}
    covered = {c.name for c in C.cases()} | set(C.ELSEWHERE) | set(C.RANDOM)
    missing = sorted(n for n in names - covered
                     if n in dir(tp) and not isinstance(getattr(jp, n, None),
                                                        type))
    assert not missing, missing


# -- random ops ---------------------------------------------------------------
# JAX keys and PyTorch's generators cannot give the same numbers: the
# random ops are held by shape, dtype, range, moments and determinism
# under ``paddle.seed``.
MOMENTS = {       # name: (mean, std) of the samples, or None
    "uniform": (0.5, 5 / 12 ** 0.5), "uniform_random": (0.0, 2 / 12 ** 0.5),
    "rand": (0.5, 1 / 12 ** 0.5), "randn": (0.0, 1.0),
    "standard_normal": (0.0, 1.0), "normal": (1.0, 2.0),
    "gaussian_random": (0.0, 1.0), "gaussian": (0.0, 1.0),
    "randint": (5.0, 2.0), "bernoulli": (0.3, 0.21 ** 0.5),
    "sampling_id": (0.9, 0.09 ** 0.5),
}
RANGE = {"uniform": (-2.0, 3.0), "uniform_random": (-1.0, 1.0),
         "rand": (0.0, 1.0), "randint": (2, 8), "bernoulli": (0, 1),
         "sampling_id": (0, 1), "multinomial": (0, 2)}


def _sample(P, name):
    args, kwargs = C.RANDOM[name]
    rng = np.random.RandomState(0)
    args = [C._inputs(P, C.make(a, rng), False) for a in args]
    fn = P.tensor if name in ("standard_normal", "shuffle") else P
    return np.asarray(getattr(fn, name)(*args, **kwargs).numpy())


@pytest.mark.parametrize("name", sorted(C.RANDOM))
def test_random_op_shape_dtype_range_moments_and_seed(name):
    want = _sample(jp, name)
    jp.seed(3)
    tp.seed(3)
    got = _sample(tp, name)
    assert got.shape == want.shape
    assert got.dtype == want.dtype or (got.dtype.name, want.dtype.name) \
        in C.NARROWING
    for arr in (got, want):
        if name in RANGE:
            lo, hi = RANGE[name]
            assert arr.min() >= lo and arr.max() <= hi, (arr.min(),
                                                         arr.max())
        if name in MOMENTS:
            mean, std = MOMENTS[name]
            n = arr.size
            assert abs(arr.mean() - mean) < 5 * std / n ** 0.5
            assert abs(arr.std() - std) < 0.1 * std
    if name in ("randperm", "shuffle"):
        np.testing.assert_array_equal(np.sort(got), np.arange(50))
    if name == "multinomial":       # without replacement: distinct ids
        assert len(set(got.tolist())) == 3
    tp.seed(3)
    np.testing.assert_array_equal(_sample(tp, name), got)
    tp.seed(4)
    assert not np.array_equal(_sample(tp, name), got) or name == \
        "multinomial"


def test_next_rng_key_is_the_default_devices_generator():
    tp.seed(5)
    g = tp.next_rng_key()
    assert g.device.type == "cpu"
    a = tp.randn([4])
    tp.seed(5)
    b = tp.randn([4])
    np.testing.assert_array_equal(a.numpy(), b.numpy())
