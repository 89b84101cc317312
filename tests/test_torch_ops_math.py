"""The port's op library against the JAX package: the rest of
``ops/math.py`` and ``ops/logic.py``.

Each op of ``ops/math.py`` and ``ops/logic.py`` runs in the JAX package
and in ``paddle_tpu_torch`` from the same seeded numpy inputs
(``tests/_torch_op_cases.py``): the outputs, and for a differentiable op
the gradients of ``sum(out * cot)`` with a seeded random cotangent, are
held to the case's tolerance class (``_torch_op_cases.TOL``): ``exact``
for integer, boolean, layout and index ops; 1e-6 relative for
elementwise float32 (``elem``); 1e-5 relative for reductions, scans,
special functions and linear algebra (``red``), each relative to the
output's largest value. A dtype differs only where JAX's 32-bit mode
narrowed the type the op asks for (int64 to int32, ...): those cases are
exactly the ones in ``NARROWED`` (ROADMAP queue 3's dtype rule).
"""
import pytest

import paddle_tpu as jp
import paddle_tpu.tensor  # noqa: F401  (the v1.8 spellings)
import paddle_tpu_torch as tp
from paddle_tpu_torch._device import set_default_device

import _torch_op_cases as C

CASES = [c for c in C.cases("math") if c.name not in C.UNARY_DOMAIN
         and c.name not in C.BINARY_DOMAIN
         and not c.name.startswith("elementwise_")
         and c.name != "floor_mod"] + C.cases("logic")
NARROWED = {
    "bitwise_and",
    "bitwise_not",
    "bitwise_or",
    "bitwise_xor",
    "count_nonzero",
    "hash_",
    "shift_left",
    "shift_right",
    "sum_bool",
}


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield
    set_default_device(None)


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
    """Each public op of ``paddle_tpu.ops.math`` and ``ops.logic`` is a
    case of these files or checked where ``_torch_op_cases.ELSEWHERE``
    says."""
    names = set()
    for mod in (jp.ops.math, jp.ops.logic):
        names |= {n for n in getattr(mod, "__all__", dir(mod))
                   if not n.startswith("_") and callable(getattr(mod, n))
                   and getattr(getattr(mod, n), "__module__", "")
                   .startswith("paddle_tpu")}
    covered = {c.name for c in C.cases()} | set(C.ELSEWHERE) | set(C.RANDOM)
    missing = sorted(n for n in names - covered
                     if n in dir(tp) and not isinstance(getattr(jp, n, None),
                                                        type))
    assert not missing, missing
