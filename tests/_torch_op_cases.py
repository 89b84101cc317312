"""Inputs for every op of the op library, shared by the CPU parity tests
(``tests/test_torch_ops_*.py``, the JAX package against the port) and
``chip_smoke.py``'s ``ops_parity`` phase (the port on the card against
the port on the CPU). numpy only: no JAX, no torch.

A case is ``Case(name, args, kwargs, kind, grad)``: ``name`` the
top-level op, ``args`` a list of argument specs, ``kind`` the class of
its tolerance, ``grad`` whether the gradient of ``sum(out * cot)`` is
compared too. An argument spec is a plain Python value, or a tuple:

- ``("f", shape)``: standard normal float32;
- ``("pos", shape)``: float32 in [0.5, 2.5);
- ``("unit", shape)``: float32 in (-0.9, 0.9);
- ``("gt1", shape)``: float32 in [1.5, 3.5);
- ``("i", shape, lo, hi)``: int64 in [lo, hi);
- ``("b", shape)``: bool;
- ``("spd", n)``: a float32 symmetric positive definite n x n matrix;
- ``("arr", value, dtype)``: a fixed array;
- ``("list", spec, spec, ...)``: a list of the specs' tensors.

Tolerance classes (``TOL``): ``exact`` (integer, boolean, layout and
index results, and float results that are copies of input elements),
``elem`` (elementwise float32: 1e-6 relative), ``red`` (reductions,
scans and linear algebra: 1e-5 relative). A relative bound r is held as
``|port - jax| <= r * max|jax|`` over each output, the largest value of
the reference setting the scale (``assert_allclose(rtol=r, atol=r *
max|jax|)``): an element near a zero of the function (``lgamma`` near 1
and 2) is held to the output's scale, not to its own tiny value. The
special functions (``erfinv``, ``lgamma``, ``digamma``, ``i0``, the
inverse hyperbolic and trigonometric ones, ...), which XLA and PyTorch
compute by different approximations, are held to ``red``.

``CARD_TOL`` holds only the card against the CPU (``chip_smoke.py``):
the eigendecompositions (``eig``, ``eigh``, ``eigvalsh``, whose
gradient is ``v v^T``) at 3e-5 relative. An eigenvector moves by
roundoff over the eigenvalue gap, and the card's solver (cuSOLVER) and
the CPU's (LAPACK) differed by 1.08e-5 (``eig``) and 1.53e-5
(``eigvalsh``'s gradient) of the largest element on this table's 4 x 4
matrices (an H100 80GB HBM3 at 700 W against the CPU); 3e-5 leaves
twice the larger reading. JAX and the port on the CPU stay at ``red``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

TOL = {"exact": 0.0, "elem": 1e-6, "red": 1e-5}
CARD_TOL = {"eig": 3e-5, "eigh": 3e-5, "eigvalsh": 3e-5}


class Case(NamedTuple):
    name: str
    args: list
    kwargs: dict = {}
    kind: str = "elem"
    grad: bool = False
    id: str = ""

    @property
    def key(self):
        return self.id or self.name


def make(spec, rng):
    """The numpy value of one argument spec."""
    if isinstance(spec, list):
        return [make(s, rng) for s in spec]
    if not isinstance(spec, tuple) or not spec or not isinstance(spec[0],
                                                                 str):
        return spec
    kind = spec[0]
    if kind == "f":
        return rng.standard_normal(spec[1]).astype(np.float32)
    if kind == "pos":
        return (rng.random_sample(spec[1]) * 2 + 0.5).astype(np.float32)
    if kind == "unit":
        return ((rng.random_sample(spec[1]) * 2 - 1) * 0.9).astype(
            np.float32)
    if kind == "gt1":
        return (rng.random_sample(spec[1]) * 2 + 1.5).astype(np.float32)
    if kind == "i":
        return rng.randint(spec[2], spec[3], spec[1]).astype(np.int64)
    if kind == "b":
        return rng.random_sample(spec[1]) < 0.5
    if kind == "spd":
        a = rng.standard_normal((spec[1], spec[1]))
        return (a @ a.T + spec[1] * np.eye(spec[1])).astype(np.float32)
    if kind == "arr":
        return np.asarray(spec[1], dtype=spec[2])
    if kind == "list":
        return [make(s, rng) for s in spec[1:]]
    raise ValueError(spec)


F = ("f", (3, 4))
F2 = ("f", (2, 3, 4))
POS = ("pos", (3, 4))
UNIT = ("unit", (3, 4))
I = ("i", (3, 4), -5, 6)
IP = ("i", (3, 4), 1, 9)
B = ("b", (3, 4))

UNARY_DOMAIN = {
    "exp": F, "expm1": F, "log": POS, "log2": POS, "log10": POS,
    "log1p": POS, "sqrt": POS, "rsqrt": POS, "abs": F, "ceil": F,
    "floor": F, "round": F, "trunc": F, "cos": F, "sin": F, "tan": UNIT,
    "acos": UNIT, "asin": UNIT, "atan": F, "cosh": F, "sinh": F, "tanh": F,
    "acosh": ("gt1", (3, 4)), "asinh": F, "atanh": UNIT, "reciprocal": POS,
    "square": F, "sign": F, "erf": F, "erfinv": UNIT, "lgamma": POS,
    "digamma": POS, "neg": F, "conj": F, "angle": F, "frac": F,
    "sigmoid": F, "i0": F,
}
# whose values are rounded or copied (exact), or whose gradient is 0
_UNARY_EXACT = {"abs", "ceil", "floor", "round", "trunc", "sign", "neg",
                "conj", "angle", "square"}
# special functions: computed by other algorithms in XLA and PyTorch
_UNARY_RED = {"erfinv", "lgamma", "digamma", "i0", "acosh", "asinh",
              "atanh", "tan", "acos", "asin", "expm1", "log1p", "cosh",
              "sinh", "erf"}

BINARY_DOMAIN = {
    "add": (F, F), "subtract": (F, F), "multiply": (F, F),
    "divide": (F, POS), "floor_divide": (F, POS), "mod": (F, POS),
    "remainder": (F, ("f", (4,))), "pow": (POS, F),
    "maximum": (F, F), "minimum": (F, F), "fmax": (F, F), "fmin": (F, F),
    "atan2": (F, F), "hypot": (F, F), "logaddexp": (F, F),
    "heaviside": (F, F), "copysign": (F, F), "nextafter": (F, F),
    "gcd": (IP, IP), "lcm": (IP, IP),
}
_BINARY_EXACT = {"maximum", "minimum", "fmax", "fmin", "heaviside",
                 "copysign", "nextafter", "gcd", "lcm", "floor_divide",
                 "add", "subtract", "multiply"}
_NO_GRAD = {"floor_divide", "heaviside", "nextafter", "gcd", "lcm", "mod",
            "remainder", "copysign"}


def _unary_cases():
    out = []
    for n, dom in UNARY_DOMAIN.items():
        kind = "exact" if n in _UNARY_EXACT else \
            "red" if n in _UNARY_RED else "elem"
        out.append(Case(n, [dom], {}, kind, True))
    return out


def _binary_cases():
    out = []
    for n, (a, b) in BINARY_DOMAIN.items():
        kind = "exact" if n in _BINARY_EXACT else "elem"
        out.append(Case(n, [a, b], {}, kind, n not in _NO_GRAD))
    for alias, n in (("elementwise_add", "add"), ("elementwise_sub",
                     "subtract"), ("elementwise_mul", "multiply"),
                     ("elementwise_div", "divide"),
                     ("elementwise_pow", "pow"),
                     ("elementwise_max", "maximum"),
                     ("elementwise_min", "minimum"),
                     ("elementwise_mod", "mod"), ("floor_mod", "mod")):
        a, b = BINARY_DOMAIN[n]
        out.append(Case(alias, [a, b], {},
                        "exact" if n in _BINARY_EXACT else "elem",
                        n not in _NO_GRAD))
    # paddle's mod: the sign of the divisor, for ints and floats
    out.append(Case("mod", [I, ("arr", [[3, -3, 4, -4]] * 3, np.int64)], {},
                    "exact", False, "mod_int_signs"))
    out.append(Case("mod", [F, ("arr", [[1.5, -1.5, 2.0, -2.0]] * 3,
                                np.float32)], {}, "elem", False,
                    "mod_float_signs"))
    out.append(Case("divide", [I, IP], {}, "elem", False, "divide_int"))
    out.append(Case("floor_divide", [I, IP], {}, "exact", False,
                    "floor_divide_int"))
    out.append(Case("add", [F, 2.5], {}, "exact", True, "add_scalar"))
    out.append(Case("multiply", [I, 3], {}, "exact", False, "mul_int"))
    return out


def _math_cases():
    return [
        Case("scale", [F], {"scale": 2.0, "bias": 0.5}, "elem", True),
        Case("scale", [F], {"scale": 2.0, "bias": 0.5,
                            "bias_after_scale": False, "act": "relu"},
             "elem", True, "scale_before_relu"),
        Case("clip", [F], {"min": -0.5, "max": 0.5}, "exact", True),
        Case("lerp", [F, F, ("unit", (3, 4))], {}, "elem", True),
        Case("stanh", [F], {}, "elem", True),
        Case("logit", [("unit", (3, 4))], {"eps": 0.05}, "elem", False),
        Case("log_sigmoid", [F], {}, "elem", True),
        Case("isnan", [("arr", [1.0, np.nan, np.inf, -np.inf], np.float32)],
             {}, "exact"),
        Case("isinf", [("arr", [1.0, np.nan, np.inf, -np.inf], np.float32)],
             {}, "exact"),
        Case("isfinite", [("arr", [1.0, np.nan, np.inf, -np.inf],
                           np.float32)], {}, "exact"),
        Case("nan_to_num", [("arr", [1.0, np.nan, np.inf, -np.inf],
                             np.float32)], {"posinf": 9.0, "neginf": -9.0},
             "exact"),
        Case("cast", [F], {"dtype": "float16"}, "exact"),
        Case("cast", [F], {"dtype": "int32"}, "exact", False, "cast_int"),
        Case("sum", [F2], {"axis": [0, 2], "keepdim": True}, "red", True),
        Case("sum", [B], {}, "exact", False, "sum_bool"),
        Case("mean", [F2], {"axis": 1}, "red", True),
        Case("max", [F2], {"axis": -1}, "exact", True),
        Case("min", [F2], {}, "exact", True),
        Case("prod", [POS], {"axis": 1}, "red", True),
        Case("any", [B], {"axis": 0}, "exact"),
        Case("all", [B], {"axis": [0, 1]}, "exact"),
        Case("logsumexp", [F2], {"axis": [1, 2]}, "red", True),
        Case("nansum", [("arr", [[1.0, np.nan], [2.0, 3.0]], np.float32)],
             {"axis": 1}, "red"),
        Case("nanmean", [("arr", [[1.0, np.nan], [2.0, 3.0]], np.float32)],
             {"axis": 1}, "red"),
        Case("std", [F2], {"axis": 2}, "red", True),
        Case("var", [F2], {"axis": [0, 1], "unbiased": False}, "red", True),
        Case("median", [("f", (3, 6))], {"axis": 1}, "red", True),
        Case("quantile", [("f", (3, 6))], {"q": 0.3, "axis": 1}, "red",
             True),
        Case("cumsum", [F2], {"axis": 1}, "red", True),
        Case("cumsum", [F], {}, "red", True, "cumsum_flat"),
        Case("cumprod", [POS], {"dim": 1}, "red", True),
        Case("cummax", [F], {"axis": 1}, "exact", True),
        Case("cummin", [F], {}, "exact", True),
        Case("count_nonzero", [I], {"axis": 1}, "exact"),
        Case("amax", [F2], {"axis": 1, "keepdim": True}, "exact", True),
        Case("amin", [F2], {"axis": [0, 2]}, "exact", True),
        Case("diff", [F], {"axis": 1}, "elem", True),
        Case("trace", [("f", (4, 4))], {"offset": 1}, "red", True),
        Case("kron", [("f", (2, 3)), ("f", (3, 2))], {}, "elem", True),
        Case("inner", [F, F], {}, "red", True),
        Case("outer", [("f", (3,)), ("f", (4,))], {}, "elem", True),
        Case("dot", [F, F], {}, "red", True),
        Case("addmm", [("f", (3, 5)), F, ("f", (4, 5))],
             {"beta": 0.5, "alpha": 2.0}, "red", True),
        Case("bitwise_and", [I, IP], {}, "exact"),
        Case("bitwise_or", [I, IP], {}, "exact"),
        Case("bitwise_xor", [I, IP], {}, "exact"),
        Case("bitwise_not", [I], {}, "exact"),
        Case("shift_left", [IP, ("i", (3, 4), 0, 4)], {}, "exact"),
        Case("shift_right", [IP, ("i", (3, 4), 0, 4)], {}, "exact"),
        Case("accuracy_op", [("f", (6, 5)), ("i", (6, 1), 0, 5)], {"k": 2},
             "exact"),
        Case("nanmedian", [("arr", [[1.0, np.nan, 3.0, 2.0],
                                    [4.0, 5.0, np.nan, np.nan]],
                            np.float32)], {"axis": 1}, "red"),
        Case("rad2deg", [F], {}, "elem", True),
        Case("deg2rad", [F], {}, "elem", True),
        Case("ldexp", [F, ("i", (3, 4), -3, 4)], {}, "exact"),
        Case("polygamma", [POS, 1], {}, "red", True),
        Case("trapezoid", [F], {"dx": 0.5}, "red", True),
        Case("trapezoid", [F], {"x": ("arr", [0.0, 0.5, 1.5, 3.0],
                                      np.float32)}, "red", True,
             "trapezoid_x"),
        Case("multiplex", [("list", F, F, F), ("i", (3, 1), 0, 3)], {},
             "exact", True),
        Case("has_inf", [("arr", [1.0, np.inf], np.float32)], {}, "exact"),
        Case("has_nan", [F], {}, "exact"),
        Case("clip_by_norm", [F], {"max_norm": 1.0}, "elem", True),
        Case("cos_sim", [F, F], {}, "red", True),
        Case("hash_", [("i", (3, 2), 0, 1000)], {"num_hash": 2,
                                                 "mod_by": 97}, "exact"),
        Case("add_position_encoding", [("f", (2, 5, 6))],
             {"alpha": 0.5, "beta": 2.0}, "elem", True),
        Case("increment", [("arr", [1.0, 2.0], np.float32)], {"value": 2.0},
             "exact"),
    ]


def _creation_cases():
    return [
        Case("zeros", [[2, 3]], {"dtype": "int32"}, "exact"),
        Case("ones", [[2, 3]], {}, "exact"),
        Case("full", [[2, 3], 1.5], {}, "exact"),
        Case("fill_constant", [[2, 2], 7], {"dtype": "int64"}, "exact"),
        Case("zeros_like", [F], {}, "exact"),
        Case("ones_like", [I], {"dtype": "float32"}, "exact"),
        Case("full_like", [F, 3.0], {}, "exact"),
        Case("arange", [0, 10, 3], {}, "exact"),
        Case("arange", [0.5, 3.0, 0.7], {}, "elem", False, "arange_float"),
        Case("range_", [5], {}, "exact"),
        Case("linspace", [0.0, 1.0, 7], {}, "elem"),
        Case("logspace", [0.0, 2.0, 5], {}, "red"),
        Case("eye", [3, 4], {}, "exact"),
        Case("empty", [[2, 2]], {}, "exact"),
        Case("empty_like", [F], {}, "exact"),
        Case("diag", [("f", (3,))], {"offset": 1}, "exact"),
        Case("diag", [("f", (3,))], {"padding_value": 9.0}, "exact", False,
             "diag_padded"),
        Case("diag", [("f", (3, 3))], {}, "exact", False, "diag_of_matrix"),
        Case("diagflat", [("f", (2, 2))], {"offset": -1}, "exact"),
        Case("tril", [F], {"diagonal": 1}, "exact", True),
        Case("triu", [F], {"diagonal": -1}, "exact", True),
        Case("meshgrid", [("f", (3,)), ("f", (2,))], {}, "exact"),
        Case("assign", [F], {}, "exact", True),
        Case("clone", [F], {}, "exact", True),
    ]


def _manip_cases():
    return [
        Case("reshape", [F2], {"shape": [4, -1]}, "exact", True),
        Case("transpose", [F2], {"perm": [2, 0, 1]}, "exact", True),
        Case("flatten", [F2], {"start_axis": 1}, "exact", True),
        Case("squeeze", [("f", (3, 1, 4, 1))], {"axis": [1, -1]}, "exact",
             True),
        Case("unsqueeze", [F], {"axis": [0, 2]}, "exact", True),
        Case("concat", [("list", F, ("f", (2, 4)))], {"axis": 0}, "exact",
             True),
        Case("stack", [("list", F, F)], {"axis": 1}, "exact", True),
        Case("unstack", [F2], {"axis": 1}, "exact", True),
        Case("split", [F2], {"num_or_sections": 2, "axis": 2}, "exact",
             True),
        Case("split", [F2], {"num_or_sections": [1, -1], "axis": 1},
             "exact", True, "split_sections"),
        Case("chunk", [F2], {"chunks": 2, "axis": -1}, "exact", True),
        Case("unbind", [F], {"axis": 0}, "exact", True),
        Case("tile", [F], {"repeat_times": [2, 1]}, "exact", True),
        Case("expand", [("f", (3, 1))], {"shape": [2, 3, 4]}, "exact", True),
        Case("expand_as", [("f", (1, 4)), F], {}, "exact", True),
        Case("broadcast_to", [("f", (3, 1))], {"shape": [3, 5]}, "exact",
             True),
        Case("broadcast_tensors", [[("f", (3, 1)), ("f", (1, 4))]], {},
             "exact", False),
        Case("slice", [F2], {"axes": [1, 2], "starts": [1, -3],
                             "ends": [3, 100]}, "exact", True),
        Case("builtins_min", [3, 5], {}, "exact"),
        Case("strided_slice", [F2], {"axes": [2], "starts": [0],
                                     "ends": [4], "strides": [2]}, "exact",
             True),
        Case("getitem", [F2, (1, slice(0, 2))], {}, "exact", True),
        Case("gather", [F, ("i", (5,), 0, 3)], {"axis": 0}, "exact", True),
        Case("gather", [F, ("i", (2, 2), 0, 4)], {"axis": 1}, "exact", True,
             "gather_2d_index"),
        Case("gather_nd", [F2, ("i", (5, 2), 0, 2)], {}, "exact", True),
        Case("take_along_axis", [F, ("i", (3, 2), 0, 4)], {"axis": 1},
             "exact", True),
        Case("put_along_axis", [F, ("arr", [[0], [1], [3]], np.int64),
                                ("f", (3, 1))], {"axis": 1}, "exact", True),
        Case("put_along_axis", [F, ("arr", [[0], [1], [3]], np.int64), 2.0],
             {"axis": 1, "reduce": "add"}, "exact", False,
             "put_along_axis_add"),
        Case("scatter", [F, ("arr", [2, 0], np.int64), ("f", (2, 4))], {},
             "exact", True),
        Case("scatter", [F, ("arr", [2, 0, 2], np.int64), ("f", (3, 4))],
             {"overwrite": False}, "elem", True, "scatter_sum"),
        Case("scatter_nd_add", [F, ("arr", [[0, 1], [2, 3], [0, 1]],
                                    np.int64), ("f", (3,))], {}, "elem",
             True),
        Case("scatter_nd", [("arr", [[1], [0]], np.int64), ("f", (2, 4)),
                            [3, 4]], {}, "exact", True),
        Case("index_select", [F, ("i", (5,), 0, 4)], {"axis": 1}, "exact",
             True),
        Case("index_sample", [F, ("i", (3, 2), 0, 4)], {}, "exact", True),
        Case("roll", [F], {"shifts": 2, "axis": 1}, "exact", True),
        Case("roll", [F], {"shifts": 5}, "exact", True, "roll_flat"),
        Case("flip", [F2], {"axis": [0, 2]}, "exact", True),
        Case("rot90", [F], {"k": 3}, "exact", True),
        Case("pad", [("f", (1, 2, 3, 4))], {"pad": [1, 2, 0, 1]}, "exact",
             True),
        Case("pad", [("f", (1, 2, 3, 4))], {"pad": [1, 2, 2, 1],
                                            "mode": "reflect"}, "exact",
             True, "pad_reflect"),
        Case("pad", [("f", (1, 3, 4, 2))], {"pad": [1, 1, 2, 0],
                                            "mode": "replicate",
                                            "data_format": "NHWC"},
             "exact", True, "pad_replicate_nhwc"),
        Case("pad", [F], {"pad": [1, 0, 2, 2], "mode": "circular"},
             "exact", True, "pad_circular_full"),
        Case("shard_index", [("i", (6, 1), 0, 20)],
             {"index_num": 20, "nshards": 3, "shard_id": 1}, "exact"),
        Case("repeat_interleave", [F], {"repeats": 2, "axis": 1}, "exact",
             True),
        Case("moveaxis", [F2], {"source": 0, "destination": 2}, "exact",
             True),
        Case("swapaxes", [F2], {"axis1": 0, "axis2": 1}, "exact", True),
        Case("as_real", [("arr", [1 + 2j, 3 - 1j], np.complex64)], {},
             "exact"),
        Case("as_complex", [("f", (3, 2))], {}, "exact"),
        Case("real", [F], {}, "exact"),
        Case("imag", [F], {}, "exact"),
        Case("unique", [("i", (12,), 0, 5)], {"return_index": True,
                                              "return_inverse": True,
                                              "return_counts": True},
             "exact"),
        Case("nonzero", [("arr", [[0, 1], [2, 0]], np.int64)], {}, "exact"),
        Case("nonzero", [("arr", [[0, 1], [2, 0]], np.int64)],
             {"as_tuple": True}, "exact", False, "nonzero_tuple"),
        Case("masked_select", [F, B], {}, "exact"),
        Case("masked_fill", [F, B, 5.0], {}, "exact", True),
        Case("where", [B, F, F], {}, "exact", True),
        Case("select_scatter", [F, ("f", (4,)), 0, 1], {}, "exact", True),
        Case("diagonal", [F2], {"offset": 1, "axis1": 1, "axis2": 2},
             "exact", True),
        Case("unfold", [("f", (1, 2, 5, 5))], {"kernel_sizes": 3,
                                               "strides": 2,
                                               "paddings": 1}, "exact",
             True),
        Case("tensordot", [F2, ("f", (4, 3))], {"axes": 1}, "red", True),
        Case("tensordot", [F2, ("f", (3, 4))],
             {"axes": [[1, 2], [0, 1]]}, "red", True, "tensordot_pairs"),
        Case("crop", [F2], {"shape": [1, 2, 2], "offsets": [1, 1, 2]},
             "exact", True),
        Case("unique_consecutive", [("arr", [1, 1, 2, 2, 3, 1, 1, 2],
                                     np.int64)],
             {"return_inverse": True, "return_counts": True}, "exact"),
        Case("as_strided", [F], {"shape": [2, 3], "stride": [3, 1],
                                 "offset": 1}, "exact", True),
        Case("view", [F], {"shape_or_dtype": [4, 3]}, "exact", True),
        Case("view", [F], {"shape_or_dtype": "int32"}, "exact", False,
             "view_bitcast"),
        Case("view_as", [F, ("f", (2, 6))], {}, "exact", True),
        Case("reverse", [F], {"axis": 1}, "exact", True),
        Case("shape", [F2], {}, "exact"),
        Case("size", [F2], {}, "exact"),
        Case("rank", [F2], {}, "exact"),
        Case("space_to_depth", [("f", (1, 2, 4, 4))], {"blocksize": 2},
             "exact", True),
        Case("shuffle_channel", [("f", (1, 4, 2, 2))], {"group": 2},
             "exact", True),
        Case("pad_constant_like", [("f", (3, 5)), F], {"pad_value": 1.0},
             "exact", True),
        Case("crop_tensor", [F2], {"shape": [2, 2, 2]}, "exact", True),
        Case("fill_constant_batch_size_like", [F, [-1, 5], "float32", 2.0],
             {}, "exact"),
        Case("unique_with_counts", [("i", (10,), 0, 4)], {}, "exact"),
        Case("reshape_", [F], {"shape": [2, 6]}, "exact"),
    ]


def _logic_cases():
    out = [Case(n, [I, ("i", (3, 4), -5, 6)], {}, "exact")
           for n in ("equal", "not_equal", "less_than", "less_equal",
                     "greater_than", "greater_equal")]
    out += [Case(n, [B, B], {}, "exact")
            for n in ("logical_and", "logical_or", "logical_xor")]
    out += [
        Case("logical_and", [I, F], {}, "exact", False, "logical_and_nums"),
        Case("logical_not", [I], {}, "exact"),
        Case("isclose", [F, F], {"atol": 0.5}, "exact"),
        Case("allclose", [F, F], {"atol": 10.0}, "exact"),
        Case("equal_all", [I, I], {}, "exact"),
        Case("is_empty", [("f", (0, 3))], {}, "exact"),
    ]
    return out


def _linalg_cases():
    S = ("spd", 4)
    return [
        Case("matmul", [F2, ("f", (4, 5))], {}, "red", True),
        Case("matmul", [F, ("f", (5, 4))], {"transpose_y": True}, "red",
             True, "matmul_transpose_y"),
        Case("mm", [F, ("f", (4, 2))], {}, "red", True),
        Case("bmm", [F2, ("f", (2, 4, 3))], {}, "red", True),
        Case("mv", [F, ("f", (4,))], {}, "red", True),
        Case("norm", [F2], {}, "red", True),
        Case("norm", [F2], {"p": 1, "axis": [1]}, "red", True, "norm_p1"),
        Case("norm", [F2], {"p": float("inf"), "axis": 2}, "red", True,
             "norm_inf"),
        Case("p_norm", [F2], {"porder": 3.0}, "red", True),
        Case("dist", [F, F], {"p": 2}, "red", True),
        Case("dist", [F, F], {"p": float("inf")}, "red", True, "dist_inf"),
        Case("cholesky", [S], {}, "red", True),
        Case("cholesky_solve", [("f", (4, 2)), ("spd", 4)], {}, "red",
             False),
        Case("inv", [S], {}, "red", True),
        Case("inverse", [S], {}, "red", True),
        Case("pinv", [("f", (4, 3))], {}, "red", False),
        Case("det", [S], {}, "red", True),
        Case("slogdet", [S], {}, "red", True),
        Case("matrix_rank", [("f", (4, 3))], {}, "exact"),
        Case("matrix_power", [("f", (3, 3)), 3], {}, "red", True),
        Case("qr", [("f", (4, 3))], {}, "red", False),
        Case("svd", [("f", (4, 3))], {}, "red", False),
        Case("eig", [S], {}, "red", False),
        Case("eigh", [S], {}, "red", False),
        Case("eigvalsh", [S], {}, "red", True),
        Case("solve", [S, ("f", (4, 2))], {}, "red", True),
        Case("triangular_solve", [("spd", 4), ("f", (4, 2))],
             {"upper": False}, "red", True),
        Case("lstsq", [("f", (5, 3)), ("f", (5, 2))], {}, "red", False),
        Case("lu", [S], {}, "red", False),
        Case("multi_dot", [[F, ("f", (4, 2)), ("f", (2, 3))]], {}, "red",
             True),
        Case("cross", [("f", (2, 3)), ("f", (2, 3))], {}, "elem", True),
        Case("cov", [("f", (3, 6))], {}, "red", True),
        Case("corrcoef", [("f", (3, 6))], {}, "red", True),
        Case("cosine_similarity", [F, F], {}, "red", True),
        Case("einsum", ["ij,kj->ik", F, ("f", (2, 4))], {}, "red", True),
        Case("matrix_transpose", [F2], {}, "exact", True),
    ]


def _search_cases():
    return [
        Case("argmax", [F2], {"axis": 1}, "exact"),
        Case("argmax", [F2], {}, "exact", False, "argmax_flat"),
        Case("argmin", [F2], {"axis": -1, "keepdim": True}, "exact"),
        Case("argsort", [("i", (3, 6), 0, 4)], {"axis": 1,
                                                "descending": True},
             "exact"),
        Case("sort", [F], {"axis": 1, "descending": True}, "exact", True),
        Case("top_k", [F], {"k": 2}, "exact", True),
        Case("topk", [("i", (3, 6), 0, 3)], {"k": 3, "axis": 1,
                                             "largest": False}, "exact"),
        Case("searchsorted", [("arr", [1.0, 2.0, 4.0, 8.0], np.float32),
                              ("arr", [0.5, 2.0, 5.0, 9.0], np.float32)],
             {"right": True}, "exact"),
        Case("kthvalue", [("i", (3, 6), 0, 4)], {"k": 2, "axis": 1},
             "exact"),
        Case("mode", [("i", (3, 7), 0, 3)], {"axis": 1}, "exact"),
        Case("bincount", [("i", (10,), 0, 5)], {"minlength": 7}, "exact"),
        Case("histogram", [("f", (20,))], {"bins": 5}, "exact"),
        Case("bucketize", [F, ("arr", [-1.0, 0.0, 1.0], np.float32)], {},
             "exact"),
        Case("gather_tree", [("i", (4, 2, 3), 0, 9),
                             ("i", (4, 2, 3), 0, 3)], {}, "exact"),
        Case("edit_distance", [("i", (3, 5), 0, 4), ("i", (3, 4), 0, 4)],
             {}, "elem"),
        Case("ctc_greedy_decoder", [("f", (2, 6, 4))], {"blank": 0},
             "exact"),
    ]


def _debug_cases():
    return [
        Case("Print", [F], {"message": "Print case"}, "exact"),
        Case("Assert", [("arr", [True, True], np.bool_)], {}, "exact"),
    ]


def _tensor_ns_cases():
    """The v1.8 spellings of ``paddle.tensor``. JAX computes them on raw
    arrays, outside its tape (no gradient), so only values are held."""
    return [
        Case("tensor.addcmul", [F, F, F], {"value": 0.5}, "elem"),
        Case("tensor.elementwise_floordiv", [I, IP], {}, "exact"),
        Case("tensor.elementwise_sum", [[F, F, F]], {}, "elem"),
        Case("tensor.sums", [[F, F]], {}, "elem"),
        Case("tensor.mul", [F2, ("f", (4, 5))], {"x_num_col_dims": 2},
             "red"),
        Case("tensor.numel", [F2], {}, "exact"),
        Case("tensor.reduce_sum", [F2], {"dim": [0, 1]}, "red"),
        Case("tensor.reduce_mean", [F2], {"dim": 1, "keep_dim": True}, "red"),
        Case("tensor.reduce_max", [F2], {"dim": 2}, "exact"),
        Case("tensor.reduce_min", [F2], {}, "exact"),
        Case("tensor.reduce_prod", [("pos", (3, 4))], {"dim": 0}, "red"),
        Case("tensor.reduce_all", [B], {"dim": 1}, "exact"),
        Case("tensor.reduce_any", [B], {}, "exact"),
        Case("tensor.t", [F], {}, "exact"),
        Case("tensor.chunksqueeze", [F2], {"chunks": 2, "axis": 2}, "exact"),
    ]


GROUPS = {
    "creation": _creation_cases,
    "math": lambda: _unary_cases() + _binary_cases() + _math_cases(),
    "manipulation": _manip_cases,
    "logic": _logic_cases,
    "linalg": _linalg_cases,
    "search": _search_cases,
    "debug": _debug_cases,
    "tensor": _tensor_ns_cases,
}


def cases(*groups):
    out = []
    for g in groups or GROUPS:
        out += GROUPS[g]()
    return out


# random ops: held by shape, dtype, range, moments and determinism
RANDOM = {
    "uniform": ([[2000]], {"min": -2.0, "max": 3.0}),
    "uniform_random": ([[2000]], {}),
    "rand": ([[2000]], {}),
    "randn": ([[4000]], {}),
    "standard_normal": ([[4000]], {}),
    "normal": ([], {"mean": 1.0, "std": 2.0, "shape": [4000]}),
    "gaussian_random": ([], {"shape": [4000]}),
    "gaussian": ([], {"shape": [4000]}),
    "randint": ([2, 9], {"shape": [3000]}),
    "randperm": ([50], {}),
    "bernoulli": ([("arr", np.full((4000,), 0.3), np.float32)], {}),
    "multinomial": ([("arr", [0.1, 0.2, 0.7], np.float32)],
                    {"num_samples": 3}),
    "sampling_id": ([("arr", np.tile([[0.1, 0.9]], (2000, 1)),
                      np.float32)], {}),
    "shuffle": ([("arr", np.arange(50), np.int64)], {}),
}

# ops whose inputs no spec of this table can build as both packages take
# them, with where they are checked instead
ELSEWHERE = {
    "py_func": "tests/test_torch_tensor.py (host callback with backward)",
    "beam_search_decode": "tests/test_torch_nmt.py",
    "beam_search_step": "tests/test_torch_nmt.py",
    "primitive": "tests/test_torch_tensor.py (a registered op)",
    "unwrap": "tests/test_torch_tensor.py",
    "next_rng_key": "tests/test_torch_ops_linalg.py (random ops)",
    "Tensor": "tests/test_torch_tensor.py",
}


NARROWING = {("int64", "int32"), ("float64", "float32"),
             ("complex128", "complex64"), ("uint64", "uint32")}


def _sign_cols(m):
    """Each column of ``m`` with the sign that makes its largest-magnitude
    element positive (singular and eigenvectors are defined up to
    sign)."""
    idx = np.argmax(np.abs(m), axis=-2)
    pick = np.take_along_axis(m, idx[..., None, :], axis=-2)
    return m * np.where(pick < 0, -1, 1)


NORMALIZE = {
    "svd": lambda v: [_sign_cols(v[0]), v[1],
                      np.swapaxes(_sign_cols(np.swapaxes(v[2], -1, -2)),
                                  -1, -2)],
    "eigh": lambda v: [v[0], _sign_cols(v[1])],
}


def _inputs(P, value, diff):
    if isinstance(value, np.ndarray):
        grad = diff and value.dtype.kind == "f"
        return P.to_tensor(value, stop_gradient=not grad)
    if isinstance(value, list) and any(isinstance(v, np.ndarray)
                                       for v in value):
        return [_inputs(P, v, diff) for v in value]
    return value


def _leaves(out):
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _np(x):
    if hasattr(x, "numpy"):
        if getattr(x, "is_cuda", False):
            x = x.cpu()
        return np.asarray(x.numpy())
    return np.asarray(x)


def _grad_leaves(args):
    out = []
    for a in args:
        if isinstance(a, list):
            out += _grad_leaves(a)
        elif hasattr(a, "stop_gradient") and not a.stop_gradient:
            out.append(a)
    return out


def run(P, case: Case, seed: int = 0, grad: bool = True, check=None):
    """``case`` through the package ``P`` (``paddle_tpu`` or
    ``paddle_tpu_torch``, same API): (the outputs as numpy arrays, the
    gradients of ``sum(out * cot)`` for each float input that takes one,
    or None). ``check``, when given, sees the op's raw result."""
    rng = np.random.RandomState(seed)
    with_grad = grad and case.grad
    args = [_inputs(P, make(a, rng), with_grad) for a in case.args]
    kwargs = {k: _inputs(P, make(v, rng), False)
              for k, v in case.kwargs.items()}
    fn = P
    for part in case.name.split("."):
        fn = getattr(fn, part)
    out = fn(*args, **kwargs)
    if check is not None:
        check(out)
    outs = _leaves(out)
    values = [_np(o) for o in outs]
    if case.name in NORMALIZE:
        values = NORMALIZE[case.name](values)
    if not with_grad:
        return values, None
    crng = np.random.RandomState(seed + 1)
    loss = None
    for o, v in zip(outs, values):
        if v.dtype.kind != "f" or getattr(o, "stop_gradient", True):
            continue
        cot = P.to_tensor(crng.standard_normal(v.shape).astype(v.dtype))
        term = (o * cot).sum()
        loss = term if loss is None else loss + term
    leaves = _grad_leaves(args)
    if loss is None or not leaves:
        return values, None
    loss.backward()
    return values, [np.zeros(tuple(t.shape), _np(t).dtype) if t.grad is None
                    else _np(t.grad) for t in leaves]


def assert_close(got, want, kind, what="", rtol=None):
    """``got`` (the port's) against ``want`` by the ``kind`` tolerance
    (the module docstring), or by ``rtol`` when given; dtypes equal but
    for :data:`NARROWING` (port's, JAX's) pairs, which are returned."""
    narrowed = []
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        if g.dtype != w.dtype:
            assert (g.dtype.name, w.dtype.name) in NARROWING, \
                (what, i, g.dtype, w.dtype)
            narrowed.append((g.dtype.name, w.dtype.name))
        r = TOL[kind] if rtol is None else rtol
        if r == 0.0 or g.dtype.kind in "biub":
            if g.dtype.kind in "fc":
                np.testing.assert_array_equal(g, w.astype(g.dtype),
                                              err_msg=f"{what}[{i}]")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{what}[{i}]")
            continue
        w64, g64 = w.astype(np.complex128 if w.dtype.kind == "c"
                            else np.float64), g.astype(
            np.complex128 if g.dtype.kind == "c" else np.float64)
        finite = np.isfinite(w64)
        np.testing.assert_array_equal(np.isfinite(g64), finite,
                                      err_msg=f"{what}[{i}] finiteness")
        np.testing.assert_array_equal(g64[~finite], w64[~finite],
                                      err_msg=f"{what}[{i}] non-finite")
        if not finite.any():
            continue
        scale = np.abs(w64[finite])
        err = np.abs(g64[finite] - w64[finite])
        bound = r * scale.max()
        assert (err <= bound).all(), (
            f"{what}[{i}]: max error {err.max()} over bound "
            f"(rel {r}); worst at {np.argmax(err - bound)}")
    return narrowed
