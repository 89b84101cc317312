"""The port's ``Tensor`` and autograd against the JAX package, on the CPU.

The same seeded numpy values go through ``paddle_tpu`` and
``paddle_tpu_torch``: ``to_tensor``'s dtype rule, the tensor's own
methods (``stop_gradient``, ``backward`` accumulating over two calls,
``clear_gradient``, ``set_value``, ``detach``, ``clone``, indexing,
``astype``/``cast``, ``numpy`` of a tensor that needs a gradient,
``item``, ``tolist``), every operator of ``math_op_patch`` (reflected
forms, paddle's ``mod`` sign rule, comparisons), the names whose paddle
and torch meanings clash (``size``, ``transpose``, ``split``,
``gather``, ``sort``/``max``/``min`` with an axis, ``expand``,
``flatten``, ``backward``, ``numpy``, ``dtype``, ``stop_gradient``,
``astype``, ``clear_gradient``, ``set_value``), ``autograd.grad``
(``retain_graph``, ``create_graph`` double and third gradients,
``allow_unused``, ``no_grad_vars``, ``grad_outputs``), ``PyLayer``,
``no_grad``/``enable_grad``; a tiny BERT forward fed ``to_tensor``
inputs equals the one fed plain torch tensors bit for bit (the port's
own code keeps torch semantics). Values within 1e-6 relative unless an
exact result is stated.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu import autograd as jag
from paddle_tpu_torch import autograd as tag
from paddle_tpu_torch._device import set_default_device
from paddle_tpu_torch.framework.dtype import dtype_name
from paddle_tpu_torch.nn.layer import load_numpy_state


@pytest.fixture(autouse=True)
def _cpu():
    tp.set_device("cpu")
    yield
    set_default_device(None)
    jp.set_default_dtype("float32")
    tp.set_default_dtype("float32")


def _same(a, b, rtol=1e-6, exact=False):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol)


def _pair(arr, stop_gradient=True):
    return (jp.to_tensor(arr, stop_gradient=stop_gradient),
            tp.to_tensor(arr, stop_gradient=stop_gradient))


RNG = np.random.RandomState(0)
A = RNG.randn(3, 4).astype(np.float32)
Bm = RNG.randn(3, 4).astype(np.float32)


# -- to_tensor --------------------------------------------------------------
@pytest.mark.parametrize("data,jax_dtype,port_dtype", [
    (1.5, "float32", "float32"),                 # the default dtype
    ([1.0, 2.0], "float32", "float32"),
    (3, "int32", "int64"),                       # narrowed by JAX's x64 off
    ([1, 2], "int32", "int64"),
    (True, "bool", "bool"),
    (np.arange(3, dtype=np.int64), "int32", "int64"),
    (np.arange(3, dtype=np.int32), "int32", "int32"),
    (np.ones(2, np.float64), "float32", "float64"),
    (np.ones(2, np.float16), "float16", "float16"),
    (np.ones(2, np.uint8), "uint8", "uint8"),
])
def test_to_tensor_dtype_rule(data, jax_dtype, port_dtype):
    j, t = jp.to_tensor(data), tp.to_tensor(data)
    assert np.dtype(j.dtype).name == jax_dtype
    assert dtype_name(t.dtype) == port_dtype
    _same(t.numpy(), j.numpy(), exact=True)
    assert isinstance(t, tp.Tensor) and t.stop_gradient


def test_to_tensor_default_dtype_and_explicit_dtype():
    jp.set_default_dtype("float16")
    tp.set_default_dtype("float16")
    assert np.dtype(jp.get_default_dtype()).name == "float16"
    assert np.dtype(tp.get_default_dtype()).name == "float16"
    assert dtype_name(tp.to_tensor(2.5).dtype) == \
        np.dtype(jp.to_tensor(2.5).dtype).name == "float16"
    assert dtype_name(tp.to_tensor([1, 2], dtype="float32").dtype) == \
        "float32"
    assert tp.to_tensor(A, dtype="bfloat16").dtype == tp.bfloat16
    assert tp.to_tensor(A).place == tp.CPUPlace(0)
    assert tp.to_tensor(A, place=tp.CPUPlace()).device.type == "cpu"


# -- the tensor's own methods --------------------------------------------------
def test_backward_accumulates_over_two_calls_and_clear_gradient():
    (jx, tx) = _pair(A, stop_gradient=False)
    for x in (jx, tx):
        assert not x.stop_gradient
        for _ in range(2):
            ((x * x).sum() * 0.5).backward()
    _same(tx.grad.numpy(), jx.grad.numpy())
    _same(tx.grad.numpy(), 2 * A)
    tx.clear_gradient()
    jx.clear_gradient()
    assert tx.grad is None and jx.grad is None
    # a non-scalar seeds ones, as JAX does
    (tx * 3).backward()
    (jx * 3).backward()
    _same(tx.grad.numpy(), jx.grad.numpy(), exact=True)


def test_stop_gradient_detach_clone_set_value_and_numpy():
    jx, tx = _pair(A, stop_gradient=False)
    _same(tx.numpy(), jx.numpy(), exact=True)     # needs a gradient: works
    for x in (jx, tx):
        d = x.detach()
        assert d.stop_gradient and not x.stop_gradient
        c = x.clone()
        assert not c.stop_gradient
        (c * 2).sum().backward()
    _same(tx.grad.numpy(), jx.grad.numpy(), exact=True)
    assert isinstance(tx.detach(), tp.Tensor)
    for x in (jx, tx):
        x.stop_gradient = True
        assert x.stop_gradient
        x.set_value(Bm)
    _same(tx.numpy(), jx.numpy(), exact=True)
    with pytest.raises(ValueError):
        tx.set_value(np.zeros((2, 2), np.float32))
    one_j, one_t = _pair(np.float32(2.5))
    assert one_t.item() == one_j.item() == 2.5
    assert tx.tolist() == jx.tolist()
    assert float(one_t) == 2.5 and int(_pair(np.int64(3))[1]) == 3


def test_indexing_get_and_set():
    jx, tx = _pair(A)
    for idx in (1, (slice(0, 2), 3), (Ellipsis, 1), slice(None, None, 2)):
        _same(tx[idx].numpy(), jx[idx].numpy(), exact=True)
        assert isinstance(tx[idx], tp.Tensor)
    ji, ti = _pair(np.array([2, 0], np.int64))
    _same(tx[ti].numpy(), jx[ji].numpy(), exact=True)
    jx[1] = 7.0
    tx[1] = 7.0
    jx[0, 1:3] = jp.to_tensor(np.array([1.0, 2.0], np.float32))
    tx[0, 1:3] = tp.to_tensor(np.array([1.0, 2.0], np.float32))
    _same(tx.numpy(), jx.numpy(), exact=True)
    assert [r.shape for r in tx] == [tuple(r.shape) for r in jx]


def test_astype_and_cast():
    jx, tx = _pair(A * 10)
    for dt in ("int32", "float16", "bool", "float64"):
        j, t = jx.astype(dt), tx.astype(dt)
        _same(t.numpy(), j.numpy().astype(t.numpy().dtype), exact=True)
        assert isinstance(t, tp.Tensor)
    assert tx.cast("int32").dtype == tp.int32


# -- the operators ---------------------------------------------------------------
BINOPS = ["__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
          "__rmul__", "__truediv__", "__rtruediv__", "__floordiv__",
          "__rfloordiv__", "__mod__", "__rmod__", "__pow__", "__rpow__",
          "__eq__", "__ne__", "__lt__", "__le__", "__gt__", "__ge__"]


@pytest.mark.parametrize("op", BINOPS)
@pytest.mark.parametrize("other", ["tensor", "scalar"])
def test_binary_operator_matches_jax(op, other):
    x = np.abs(A) + 0.5 if "pow" in op else A
    y = np.abs(Bm) + 0.5 if ("div" in op or "mod" in op or "pow" in op) \
        else Bm
    jx, tx = _pair(x)
    jy, ty = _pair(y)
    if other == "scalar":
        jy = ty = 1.5 if "pow" not in op else 2.0
    j = getattr(jx, op)(jy)
    t = getattr(tx, op)(ty)
    assert isinstance(t, tp.Tensor)
    _same(t.numpy(), np.asarray(j.numpy()), exact=op not in (
        "__truediv__", "__rtruediv__", "__pow__", "__rpow__", "__mod__",
        "__rmod__"))


def test_mod_takes_the_divisors_sign_and_int_division_is_true():
    xi = np.array([7, -7, 7, -7], np.int64)
    yi = np.array([3, 3, -3, -3], np.int64)
    (jx, tx), (jy, ty) = _pair(xi), _pair(yi)
    _same((tx % ty).numpy(), (jx % jy).numpy(), exact=True)
    _same((tx % ty).numpy(), [1, 2, -2, -1], exact=True)
    _same((tx // ty).numpy(), (jx // jy).numpy(), exact=True)
    assert dtype_name((tx / ty).dtype) == "float32"
    _same((tx / ty).numpy(), (jx / jy).numpy())
    xf = np.array([5.5, -5.5], np.float32)
    (jf, tf) = _pair(xf)
    _same((tf % 2.0).numpy(), (jf % 2.0).numpy())


@pytest.mark.parametrize("op", ["__and__", "__or__", "__xor__"])
def test_logical_operators_match_jax(op):
    a, b = A > 0, Bm > 0
    (ja, ta), (jb, tb) = _pair(a), _pair(b)
    _same(getattr(ta, op)(tb).numpy(), getattr(ja, op)(jb).numpy(),
          exact=True)


@pytest.mark.parametrize("op", ["__neg__", "__abs__", "__invert__",
                                "__matmul__", "__rmatmul__"])
def test_unary_and_matmul_operators_match_jax(op):
    x = A > 0 if op == "__invert__" else A
    jx, tx = _pair(x)
    if "matmul" in op:
        jy, ty = _pair(Bm.T.copy())
        j, t = getattr(jx, op)(jy), getattr(tx, op)(ty)
    else:
        j, t = getattr(jx, op)(), getattr(tx, op)()
    _same(t.numpy(), j.numpy(), rtol=1e-5)


def test_operator_gradients_match_jax():
    jx, tx = _pair(np.abs(A) + 0.5, stop_gradient=False)
    jy, ty = _pair(np.abs(Bm) + 0.5, stop_gradient=False)
    for x, y in ((jx, jy), (tx, ty)):
        out = (x * y + x / y - 2.0 ** x + y ** 1.5 - (-x) % 1.25) @ y.T
        out.sum().backward()
    _same(tx.grad.numpy(), jx.grad.numpy(), rtol=1e-5)
    _same(ty.grad.numpy(), jy.grad.numpy(), rtol=1e-5)


# -- names whose paddle and torch meanings clash ----------------------------------
def test_clashing_names_keep_paddle_semantics_on_a_tensor():
    x = RNG.randn(2, 3, 4).astype(np.float32)
    jx, tx = _pair(x)
    assert tx.size == jx.size == 24 and isinstance(tx.size, int)
    assert tx.size() == torch.Size([2, 3, 4]) and tx.size(1) == 3
    _same(tx.transpose([2, 0, 1]).numpy(), jx.transpose([2, 0, 1]).numpy(),
          exact=True)
    js, ts = jx.split(2, axis=2), tx.split(2, axis=2)     # a count
    assert len(ts) == len(js) == 2
    for a, b in zip(ts, js):
        _same(a.numpy(), b.numpy(), exact=True)
    ji, ti = _pair(np.array([2, 0, 2], np.int64))
    _same(tx.gather(ti, axis=1).numpy(), jx.gather(ji, axis=1).numpy(),
          exact=True)
    for name in ("sort", "max", "min"):
        j = getattr(jx, name)(1)
        t = getattr(tx, name)(1)
        assert isinstance(t, tp.Tensor)                   # values only
        _same(t.numpy(), j.numpy(), exact=True)
    je, te = _pair(np.ones((3, 1), np.float32))
    _same(te.expand([2, 3, 4]).numpy(), je.expand([2, 3, 4]).numpy(),
          exact=True)
    _same(tx.flatten(1, 2).numpy(), jx.flatten(1, 2).numpy(), exact=True)
    assert dtype_name(tx.dtype) == np.dtype(jx.dtype).name == "float32"
    assert tx.dtype == tp.float32
    assert tx.astype("int32").dtype == tp.int32
    jg, tg = _pair(x, stop_gradient=False)
    for g in (jg, tg):
        (g * g).sum().backward(None, retain_graph=False)
        assert not g.stop_gradient
        g.clear_gradient()
        assert g.grad is None
        g.set_value(x * 2)
    _same(tg.numpy(), jg.numpy(), exact=True)


def test_torch_semantics_inside_the_port():
    """A ``Tensor`` given to the port's code is a torch tensor there:
    ``F.cross_entropy`` calls torch methods on what it is given, and a
    parameter's own methods inside a layer are torch's."""
    from paddle_tpu_torch.framework.tensor import entry

    tx = tp.to_tensor(A)

    @entry
    def port_code():
        assert tx.max(1).indices.shape == (3,)     # torch: (values, idx)
        assert len(tx.split(1, 0)) == 3             # torch: a size
        assert tx.transpose(0, 1).shape == (4, 3)
        assert type(tx + 1) is torch.Tensor

    port_code()
    assert type(tx + 1) is tp.Tensor


def test_parameters_are_tensors_with_numpy():
    lin = tp.nn.Linear(3, 2, device="cpu")
    w = lin.weight
    assert isinstance(w, tp.Tensor) and isinstance(w, torch.nn.Parameter)
    assert w.numpy().shape == (3, 2) and not w.stop_gradient
    assert w.persistable and w.name.endswith("w_0")
    out = lin(tp.to_tensor(A[:, :3]))
    assert isinstance(out, tp.Tensor)
    assert type(lin(torch.from_numpy(A[:, :3]))) is torch.Tensor
    seq = tp.nn.Sequential(tp.nn.Linear(4, 2, device="cpu"), tp.nn.ReLU())
    assert seq[0].weight.numpy().shape == (4, 2)


# -- autograd.grad -------------------------------------------------------------------
def test_grad_retain_graph_and_allow_unused_and_grad_outputs():
    jx, tx = _pair(A, stop_gradient=False)
    jz, tz = _pair(Bm, stop_gradient=False)
    cot = RNG.randn(3, 4).astype(np.float32)
    res = []
    for P, ag, x, z in ((jp, jag, jx, jz), (tp, tag, tx, tz)):
        y = x * x * 3.0
        g1, = ag.grad(y, [x], grad_outputs=[P.to_tensor(cot)],
                      retain_graph=True)
        g2, gz = ag.grad([y.sum()], [x, z])            # unused z: zeros
        none = ag.grad([y.sum()], [x, z], allow_unused=True)[1]
        assert x.grad is None                          # .grad untouched
        res.append((g1.numpy(), g2.numpy(), gz.numpy(), none))
    for a, b in zip(res[0][:3], res[1][:3]):
        _same(b, a)
    assert res[0][3] is None and res[1][3] is None


def test_grad_no_grad_vars_stop_flow():
    jx, tx = _pair(A, stop_gradient=False)
    res = []
    for ag, x in ((jag, jx), (tag, tx)):
        h = x * 2.0
        y = (h * h + x).sum()
        gx, gh = ag.grad([y], [x, h], no_grad_vars=[h])
        res.append((gx.numpy(), gh.numpy()))
    _same(res[1][0], res[0][0])
    _same(res[1][0], np.ones_like(A))              # only the direct path
    _same(res[1][1], res[0][1])


def test_double_and_third_gradients_match_jax():
    x = np.array([0.5, 1.5, -2.0], np.float32)
    out = []
    for P, ag in ((jp, jag), (tp, tag)):
        t = P.to_tensor(x, stop_gradient=False)
        y = (t ** 4).sum()
        g1, = ag.grad(y, [t], create_graph=True)
        g2, = ag.grad(g1.sum(), [t], create_graph=True)
        g3, = ag.grad(g2.sum(), [t])
        t2 = P.to_tensor(x, stop_gradient=False)
        dx, = ag.grad((t2 * t2 * t2).sum(), [t2], create_graph=True)
        dx.sum().backward()
        out.append([g1.numpy(), g2.numpy(), g3.numpy(), t2.grad.numpy()])
    for a, b in zip(out[0], out[1]):
        _same(b, a, rtol=1e-5)
    _same(out[1][2], 24 * x, rtol=1e-5)


def test_gradient_penalty_matches_jax():
    rng = np.random.RandomState(1)
    xv = rng.randn(5, 2).astype(np.float32)
    w1 = rng.randn(2, 8).astype(np.float32)
    w2 = rng.randn(8, 1).astype(np.float32)
    res = []
    for P, ag in ((jp, jag), (tp, tag)):
        W1 = P.to_tensor(w1, stop_gradient=False)
        W2 = P.to_tensor(w2, stop_gradient=False)
        x = P.to_tensor(xv, stop_gradient=False)
        d = P.matmul(P.tanh(P.matmul(x, W1)), W2).sum()
        g, = ag.grad(d, [x], create_graph=True)
        gp = (((g * g).sum(axis=1) + 1e-12).sqrt() - 1.0)
        gp = (gp * gp).mean() * 10.0
        gp.backward()
        res.append((float(gp.numpy()), W1.grad.numpy(), W2.grad.numpy()))
    assert abs(res[1][0] - res[0][0]) <= 1e-5 * abs(res[0][0])
    _same(res[1][1], res[0][1], rtol=1e-5)
    _same(res[1][2], res[0][2], rtol=1e-5)


# -- PyLayer, no_grad, enable_grad ---------------------------------------------------
def _pylayer(P, ag):
    class Cube(ag.PyLayer):
        @staticmethod
        def forward(ctx, x, k=1.0):
            ctx.save_for_backward(x)
            return x * x * x * k

        @staticmethod
        def backward(ctx, dy):
            x, = ctx.saved_tensor
            return dy * 3.0 * x * x

    return Cube


def test_pylayer_matches_jax():
    out = []
    for P, ag in ((jp, jag), (tp, tag)):
        x = P.to_tensor(A, stop_gradient=False)
        y = _pylayer(P, ag).apply(x, k=2.0)
        (y * 2.0).sum().backward()
        out.append((y.numpy(), x.grad.numpy()))
        assert not y.stop_gradient
    _same(out[1][0], out[0][0])
    # the user backward ignores k (as written); both packages agree
    _same(out[1][1], out[0][1])


def test_pylayer_double_gradient_through_create_graph():
    Cube = _pylayer(tp, tag)
    x = tp.to_tensor(np.array([1.0, -2.0], np.float32), stop_gradient=False)
    g, = tag.grad(Cube.apply(x).sum(), [x], create_graph=True)
    g2, = tag.grad(g.sum(), [x])
    _same(g2.numpy(), [6.0, -12.0])


def test_no_grad_and_enable_grad():
    jx, tx = _pair(A, stop_gradient=False)
    for P, x in ((jp, jx), (tp, tx)):
        with P.no_grad():
            y = x * 2
            with P.enable_grad():
                z = x * 2
        assert y.stop_gradient and not z.stop_gradient

        @P.no_grad()
        def f(v):
            return v * 3

        assert f(x).stop_gradient


# -- registry, flags, host callbacks, dygraph names, save/load ----------------------
def test_primitive_registers_and_check_nan_inf_names_the_op():
    from paddle_tpu_torch.framework.op import OP_REGISTRY

    @tp.primitive("twice_plus_log")
    def twice_plus_log(x):
        return 2 * x + torch.log(x)

    assert OP_REGISTRY["twice_plus_log"] is twice_plus_log
    out = twice_plus_log(tp.to_tensor(np.ones(2, np.float32)))
    assert isinstance(out, tp.Tensor)
    tp.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="twice_plus_log"):
            twice_plus_log(tp.to_tensor(np.zeros(2, np.float32)))
        with pytest.raises(FloatingPointError, match="log"):
            tp.log(tp.to_tensor(-np.ones(2, np.float32)))
    finally:
        tp.set_flags({"check_nan_inf": False})
    del OP_REGISTRY["twice_plus_log"]


def test_flags_mirror_jax_and_the_unported_fallback_raises():
    assert set(jp.framework.flags.all_flags()) <= set(
        tp.framework.flags.all_flags())
    assert tp.get_flags(["sp_fallback_warn"]) == {"sp_fallback_warn": True}
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        tp.set_flags({"sp_mask_fallback": True})
    tp.set_flags({"sp_mask_fallback": False})


def test_py_func_matches_jax_and_runs_its_backward():
    def fwd(x):
        return np.tanh(x)

    def bwd(x, dy):
        return dy * (1 - np.tanh(x) ** 2)

    out = []
    for P in (jp, tp):
        x = P.to_tensor(A, stop_gradient=False)
        y = P.py_func(fwd, x, P.to_tensor(np.zeros_like(A)),
                      backward_func=bwd)
        out.append((x, y))
    _same(out[1][1].numpy(), out[0][1].numpy())
    # JAX's eager py_func leaves its tape (its custom VJP serves jit); the
    # port's records the user's backward
    x, y = out[1]
    (y * 2).sum().backward()
    _same(x.grad.numpy(), bwd(A, 2 * np.ones_like(A)))


def test_unwrap_device_and_dygraph_names(tmp_path):
    t = tp.to_tensor(A)
    assert type(tp.unwrap(t)) is torch.Tensor
    assert tp.get_device() == "cpu" and tp.is_compiled_with_cuda()
    assert not tp.is_compiled_with_tpu()
    v = tp.dygraph.to_variable(A, name="v")
    assert v.name == "v" and isinstance(v, tp.Tensor)
    with tp.dygraph.guard():
        assert tp.dygraph.enabled() and tp.in_dynamic_mode()
    assert tp.dygraph.BackwardStrategy().sort_sum_gradient is False
    with pytest.raises(NotImplementedError, match="slice 9"):
        tp.dygraph.declarative(lambda x: x)
    lin = tp.nn.Linear(3, 2, device="cpu")
    tp.dygraph.save_dygraph(lin.state_dict(), str(tmp_path / "m"))
    params, opt = tp.dygraph.load_dygraph(str(tmp_path / "m"))
    assert opt is None and set(params) == {"weight", "bias"}
    tp.save({"w": lin.weight}, str(tmp_path / "w.pdparams"))
    jw = jp.load(str(tmp_path / "w.pdparams"))["w"]     # JAX reads it
    _same(jw, lin.weight.numpy(), exact=True)


def test_set_device_is_the_default_for_everything_made_without_one():
    set_default_device(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="set_device"):
            tp.zeros([2])
        with pytest.raises(RuntimeError):
            tp.get_device()
    tp.set_device("cpu")
    assert tp.zeros([2]).device.type == "cpu"
    assert tp.framework.get_default_place() == tp.CPUPlace(0)
    with pytest.raises(ValueError):
        tp.set_device("abc")


# -- a tiny BERT: to_tensor inputs and torch inputs, bit for bit --------------------
def test_tiny_bert_forward_same_bits_for_tensor_and_torch_inputs():
    from paddle_tpu_torch.models.bert import BertConfig, BertForPretraining

    tp.seed(0)
    cfg = BertConfig.tiny()
    m = BertForPretraining(cfg, device="cpu")
    m.eval()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    tt = np.zeros((2, 16), np.int32)
    mlm = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    nsp = rng.randint(0, 2, (2,)).astype(np.int32)
    plain = [torch.from_numpy(a) for a in (ids, tt, mlm, nsp)]
    wrapped = [tp.to_tensor(a) for a in (ids, tt, mlm, nsp)]
    with torch.no_grad():
        a = m(*plain[:2])
        b = m(*wrapped[:2])
        la = m.loss(*plain)
        lb = m.loss(*wrapped)
    for x, y in zip(a if isinstance(a, tuple) else [a],
                    b if isinstance(b, tuple) else [b]):
        assert type(x) is torch.Tensor and isinstance(y, tp.Tensor)
        assert torch.equal(x, y.as_subclass(torch.Tensor))
    assert isinstance(lb, tp.Tensor) and torch.equal(
        la, lb.as_subclass(torch.Tensor))


# -- a user's code around the port's: subclasses and callbacks ----------------------
def _user_attention(P):
    """The same two user subclasses of ``nn.MultiHeadAttention`` in
    either package: one inherits ``forward``, one calls
    ``super().forward`` and goes on in paddle's methods."""

    class Inherits(P.nn.MultiHeadAttention):
        pass

    class CallsSuper(P.nn.MultiHeadAttention):
        def forward(self, q):
            out = super().forward(q, q, q)
            a, b = out.split(2, axis=2)              # paddle: a count
            return (a * b).max(axis=1)               # paddle: values only

    return Inherits, CallsSuper


def test_user_subclass_of_a_port_layer_matches_jax():
    """The port's inherited ``forward`` (and ``super().forward``) keep
    torch semantics inside while the user's own ``forward`` keeps
    paddle's: outputs and the input's gradient within 1e-6."""
    x = RNG.randn(2, 5, 16).astype(np.float32)
    for jcls, tcls in zip(_user_attention(jp), _user_attention(tp)):
        jm = jcls(16, 4)
        tm = tcls(16, 4, device="cpu")
        load_numpy_state(tm, {k: v.numpy() for k, v in
                                    jm.state_dict().items()})
        jx, tx = _pair(x, stop_gradient=False)
        jo, to = jm(jx), tm(tx)
        assert isinstance(to, tp.Tensor)
        _same(to.numpy(), jo.numpy())
        (jo * jo).sum().backward()
        (to * to).sum().backward()
        _same(tx.grad.numpy(), jx.grad.numpy(), rtol=1e-5)


def _paddle_style_loss(m, x, y):
    h = m(x)                                         # (4, 6)
    a, b = h.split(2, axis=1)                        # two (4, 3)
    return ((a.max(axis=1) - y) ** 2).mean() + \
        b.transpose([1, 0]).abs().mean()


def test_train_step_runs_a_users_loss_function_as_paddle_code():
    """``TrainStep``'s loss function is the user's: ``split(n)``,
    ``max(axis)`` and ``transpose(perm)`` are paddle's there. Three SGD
    steps' losses within 1e-6 of the JAX step's."""
    from paddle_tpu.jit import TrainStep as JTrainStep
    from paddle_tpu_torch.jit import TrainStep

    jp.seed(0)
    jm = jp.nn.Linear(4, 6)
    tm = tp.nn.Linear(4, 6, device="cpu")
    load_numpy_state(tm, {k: v.numpy() for k, v in
                                jm.state_dict().items()})
    jstep = JTrainStep(jm, _paddle_style_loss, jp.optimizer.SGD(
        learning_rate=0.1, parameters=jm.parameters()))
    tstep = TrainStep(tm, _paddle_style_loss, tp.optimizer.SGD(
        learning_rate=0.1, parameters=tm.parameters()))
    x = RNG.randn(4, 4).astype(np.float32)
    y = RNG.randn(4).astype(np.float32)
    jl = [float(jstep(*_pair(x)[:1], _pair(y)[0]).numpy())
          for _ in range(3)]
    tl = []
    for _ in range(3):
        loss = tstep(tp.to_tensor(x), tp.to_tensor(y))
        assert isinstance(loss, tp.Tensor)
        tl.append(float(loss))
    _same(tl, jl)


def test_recompute_runs_a_users_function_as_paddle_code():
    """``recompute``'s function is the user's, in the forward and in the
    backward's replay: value and gradient within 1e-6 of JAX's."""
    from paddle_tpu.optimizer.meta import recompute as jrecompute
    from paddle_tpu_torch.optimizer import recompute as trecompute

    def fn(x):
        a, b = x.split(2, axis=1)
        return (a * b).max(axis=1)

    x = RNG.randn(3, 4).astype(np.float32)
    jx, tx = _pair(x, stop_gradient=False)
    jo, to = jrecompute(fn, jx), trecompute(fn, tx)
    _same(to.numpy(), jo.numpy())
    (jo * jo).sum().backward()
    (to * to).sum().backward()
    _same(tx.grad.numpy(), jx.grad.numpy())
