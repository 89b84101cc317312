"""The port's op library against the JAX package: creation and the
generated elementwise families.

Each op of ``ops/creation.py`` and the unary and binary elementwise
families of ``ops/math.py`` runs in the JAX package and in
``paddle_tpu_torch`` from the same seeded numpy inputs
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

CASES = C.cases("creation") + [
    c for c in C.cases("math") if c.name in C.UNARY_DOMAIN
    or c.name in C.BINARY_DOMAIN or c.name.startswith("elementwise_")
    or c.name == "floor_mod"]
NARROWED = {
    "floor_divide_int",
    "gcd",
    "lcm",
    "mod_int_signs",
    "mul_int",
    "arange",
    "fill_constant",
    "range_",
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
    """Each public op of ``paddle_tpu.ops.creation`` is a case of these
    files or checked where ``_torch_op_cases.ELSEWHERE`` says."""
    names = set()
    for mod in (jp.ops.creation,):
        names |= {n for n in getattr(mod, "__all__", dir(mod))
                   if not n.startswith("_") and callable(getattr(mod, n))
                   and getattr(getattr(mod, n), "__module__", "")
                   .startswith("paddle_tpu")}
    covered = {c.name for c in C.cases()} | set(C.ELSEWHERE) | set(C.RANDOM)
    missing = sorted(n for n in names - covered
                     if n in dir(tp) and not isinstance(getattr(jp, n, None),
                                                        type))
    assert not missing, missing
