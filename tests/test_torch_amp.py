"""The port's AMP (``paddle_tpu_torch.amp``) held against the JAX
package's on the CPU.

- The cast rule: for every op name the port's models and functionals
  consult, ``maybe_cast_inputs`` gives the JAX rule's dtypes at O0, O1
  and O2, for f32, bf16 and f16 inputs and both low types.
- ``decorate``: the masters equal the pre-decorate f32 weights bit for
  bit and every parameter is its master's cast; a warmed-up optimizer's
  slots are upgraded (moments kept, master added), as in JAX;
  ``master_weight=False`` keeps no master; ``save_dtype`` pins the
  state dict's copies and ``set_state_dict``/``load_numpy_state`` write
  the live tensors.
- ``GradScaler`` against JAX's ``GradScaler`` driven with the same
  fp16 gradients set on both packages' parameters (a decorated
  ``Linear`` with SGD masters), six steps with non-finite gradients at
  steps 2, 3 and 5, at scales 128 and 1000: the scale after each
  update, the skip decisions, ``_step_count``, gradients cleared on a
  skip, the unscaled gradients bit for bit, and ``state_dict``. (JAX's
  eager tape cannot run ``loss.backward()`` through a black-listed op
  on a low-precision input, ``framework/tape.py:164``, so the scaler is
  driven with gradients, not with a backward.)
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import amp, nn, optimizer
from paddle_tpu_torch.nn.layer import load_numpy_state

OPS = ["linear", "matmul", "conv2d", "layer_norm",
       "softmax_with_cross_entropy", "fused_linear_cross_entropy", "sdpa",
       "add", "subtract", "multiply", "divide", "gelu", "relu", "tanh",
       "dropout", "embedding_fn", "fused_embedding_seq_pool",
       "batch_norm_train", "batch_norm_infer", "max_pool2d",
       "adaptive_avg_pool2d", "flatten"]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@pytest.mark.parametrize("level", ["O0", "O1", "O2"])
@pytest.mark.parametrize("low", ["bfloat16", "float16"])
def test_cast_rule_matches_jax_for_every_op(level, low):
    import jax.numpy as jnp

    for op in OPS:
        for name, tdt in DTYPES.items():
            with jamp.auto_cast(level=level, dtype=low):
                (ja,) = jamp.maybe_cast_inputs(
                    op, [jnp.zeros((2,), getattr(jnp, name))])
            with amp.auto_cast(level=level, dtype=low):
                ta, ints, none = amp.maybe_cast_inputs(
                    op, [torch.zeros(2, dtype=tdt),
                         torch.zeros(2, dtype=torch.int64), None])
            assert str(ta.dtype).replace("torch.", "") == str(ja.dtype), \
                (level, low, op, name)
            assert ints.dtype == torch.int64 and none is None


def test_amp_state_helpers_and_alias():
    assert amp.amp_guard is amp.auto_cast
    assert not amp.amp_enabled()
    with amp.auto_cast(level="O2", dtype="float16"):
        assert amp.amp_enabled() and amp.amp_dtype() == torch.float16
    with amp.auto_cast(enable=False, level="O2"):
        assert not amp.amp_enabled()
    with pytest.raises(ValueError):
        amp.auto_cast(level="O3")


def _linear_pair(dtype=None):
    paddle.seed(0)
    jl = jnn.Linear(8, 4)
    tl = nn.Linear(8, 4, device="cpu")
    load_numpy_state(tl, {k: v.numpy() for k, v in jl.state_dict().items()})
    return jl, tl


def test_decorate_masters_are_the_pre_cast_weights():
    _, tl = _linear_pair()
    before = {n: p.detach().clone() for n, p in tl.named_parameters()}
    opt = optimizer.AdamW(learning_rate=1e-3, parameters=tl.parameters())
    tl, opt = amp.decorate(tl, opt, level="O2", dtype="bfloat16")
    assert opt._multi_precision
    for n, p in tl.named_parameters():
        assert p.dtype == torch.bfloat16
        master = opt._slots[id(p)]["__master__"]
        assert master.dtype == torch.float32
        assert torch.equal(master, before[n]), n       # not a round trip
        assert torch.equal(p, master.to(torch.bfloat16))
        assert set(opt._slots[id(p)]) == {"moment1", "moment2",
                                          "__master__"}


def test_decorate_upgrades_a_warmed_up_optimizer_as_jax_does():
    """One f32 step, then decorate: the moments stay, the master is the
    f32 weight after that step; one more step then matches JAX's."""
    jl, tl = _linear_pair()
    jo = jopt.Adam(learning_rate=1e-2, parameters=jl.parameters())
    to = optimizer.Adam(learning_rate=1e-2, parameters=tl.parameters())
    rng = np.random.RandomState(0)
    g = {n: rng.randn(*p.shape).astype(np.float32)
         for n, p in jl.named_parameters()}

    def step():
        for n, p in jl.named_parameters():
            p.grad = paddle.to_tensor(g[n].astype(str(p.dtype)))
        for n, p in tl.named_parameters():
            p.grad = torch.from_numpy(g[n]).to(p.dtype)
        jo.step()
        to.step()

    step()
    m1 = {n: to._slots[id(p)]["moment1"].clone()
          for n, p in tl.named_parameters()}
    jamp.decorate(jl, jo, level="O2", dtype="bfloat16")
    amp.decorate(tl, to, level="O2", dtype="bfloat16")
    for n, p in tl.named_parameters():
        assert torch.equal(to._slots[id(p)]["moment1"], m1[n])
    step()
    jp = dict(jl.named_parameters())
    for n, p in tl.named_parameters():
        js, ts = jo._slots[id(jp[n])], to._slots[id(p)]
        assert set(js) == set(ts)
        for k in ts:
            np.testing.assert_allclose(ts[k].float().numpy(),
                                       np.asarray(js[k], np.float32),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        assert torch.equal(p, ts["__master__"].to(torch.bfloat16))


def test_decorate_without_master_weights():
    _, tl = _linear_pair()
    opt = optimizer.SGD(learning_rate=0.1, parameters=tl.parameters())
    amp.decorate(tl, opt, level="O2", dtype="float16", master_weight=False)
    assert not opt._multi_precision
    for p in tl.parameters():
        assert p.dtype == torch.float16
        p.grad = torch.ones_like(p)
    w0 = tl.weight.detach().clone()
    opt.step()
    assert not any("__master__" in s for s in opt._slots.values())
    assert tl.weight.dtype == torch.float16
    assert torch.equal(tl.weight, (w0 - torch.tensor(0.1,
                                                     dtype=torch.float16)))


def test_decorate_save_dtype_pins_the_state_dict_and_loads_live():
    """The JAX regression ``test_decorate_save_dtype_pins_state_dict``:
    with ``save_dtype`` the state dict hands out f32 copies, and loading
    reaches the live bf16 parameters (not the copies)."""
    _, tl = _linear_pair()
    amp.decorate(tl, level="O2", dtype="bfloat16", save_dtype="float32")
    sd = tl.state_dict()
    assert all(v.dtype == torch.float32 for v in sd.values())
    assert tl.weight.dtype == torch.bfloat16
    new = {k: np.full(tuple(v.shape), 0.5, np.float32) for k, v in sd.items()}
    assert tl.set_state_dict(new) == []
    assert torch.equal(tl.weight, torch.full_like(tl.weight, 0.5))
    new = {k: np.full(tuple(v.shape), 0.25, np.float32)
           for k, v in sd.items()}
    load_numpy_state(tl, new)
    assert torch.equal(tl.bias, torch.full_like(tl.bias, 0.25))
    assert tl.bias.dtype == torch.bfloat16


def test_layer_to_keeps_torch_forms_and_takes_paddle_names():
    _, tl = _linear_pair()
    ids = [id(p) for p in tl.parameters()]
    assert tl.to("float16") is tl and tl.weight.dtype == torch.float16
    tl.to(dtype="bfloat16")
    assert tl.weight.dtype == torch.bfloat16
    tl.to(torch.float32)
    tl.to("cpu")
    tl.to(device="cpu", dtype=None, blocking=True)
    assert tl.weight.dtype == torch.float32
    assert [id(p) for p in tl.parameters()] == ids
    bn = nn.BatchNorm2D(3, device="cpu").to(dtype="float16")
    assert bn._mean.dtype == bn._variance.dtype == torch.float16


def _scaler_pair(init):
    """A decorated fp16 Linear with SGD masters on both sides, and a
    GradScaler each."""
    jl, tl = _linear_pair()
    jo = jopt.SGD(learning_rate=0.1, parameters=jl.parameters())
    to = optimizer.SGD(learning_rate=0.1, parameters=tl.parameters())
    jamp.decorate(jl, jo, level="O2", dtype="float16")
    amp.decorate(tl, to, level="O2", dtype="float16")
    kw = dict(init_loss_scaling=init, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2)
    return jl, tl, jo, to, jamp.GradScaler(**kw), amp.GradScaler(**kw)


@pytest.mark.parametrize("init", [128.0, 1000.0])
def test_grad_scaler_matches_jax(init):
    jl, tl, jo, to, js, ts = _scaler_pair(init)
    rng = np.random.RandomState(int(init))
    bad_steps = {2: np.inf, 3: np.nan, 5: -np.inf}
    jp = dict(jl.named_parameters())
    for i in range(6):
        g = {n: (rng.randn(*p.shape) * init * 1e-2).astype(np.float16)
             for n, p in tl.named_parameters()}
        if i in bad_steps:
            g["weight"][1, 2] = bad_steps[i]
        for n, p in tl.named_parameters():
            jp[n].grad = paddle.to_tensor(g[n])
            p.grad = torch.from_numpy(g[n])
        js.unscale_(jo)
        ts.unscale_(to)
        for n, p in tl.named_parameters():
            np.testing.assert_array_equal(p.grad.numpy(),
                                          jp[n].grad.numpy(), err_msg=n)
        assert ts._found_inf == js._found_inf == (i in bad_steps)
        js.minimize(jo, None)
        ts.minimize(to, None)
        assert to._step_count == jo._step_count
        assert ts.get_loss_scaling() == js.get_loss_scaling()
        assert ts.state_dict() == js.state_dict()
        if i in bad_steps:
            assert all(p.grad is None for p in tl.parameters())
        for n, p in tl.named_parameters():
            master = to._slots[id(p)]["__master__"]
            assert torch.equal(p, master.to(torch.float16))
            np.testing.assert_allclose(
                master.numpy(), np.asarray(jo._slots[id(jp[n])]
                                           ["__master__"]), rtol=1e-6)
    assert to._step_count == 3
    ts.set_state_dict({"scale": 2.0 ** 40, "good": 0, "bad": 0})
    assert ts.get_loss_scaling() == 2.0 ** 40


def test_grad_scaler_scale_is_in_the_loss_type_and_disabled_is_identity():
    s = amp.GradScaler(init_loss_scaling=1000.0)
    loss = torch.tensor(0.3, dtype=torch.bfloat16)
    assert s.scale(loss).dtype == torch.bfloat16
    assert s.scale(loss) == loss * torch.tensor(1000.0, dtype=torch.bfloat16)
    off = amp.GradScaler(enable=False)
    assert off.scale(loss) is loss and not off.is_enable()
    assert off.get_loss_scaling() == 1.0


def test_save_dtype_of_a_sub_model_still_loads_the_live_tensors():
    """A decorated sub-model with ``save_dtype`` inside a parent: the
    parent's loading reaches the sub-model's live bf16 tensors."""
    _, tl = _linear_pair()
    amp.decorate(tl, level="O2", dtype="bfloat16", save_dtype="float32")
    parent = nn.Sequential(tl)
    assert parent.state_dict()["0.weight"].dtype == torch.float32
    load_numpy_state(parent, {k: np.full(tuple(v.shape), 0.5, np.float32)
                              for k, v in parent.state_dict().items()})
    assert tl.weight.dtype == torch.bfloat16
    assert torch.equal(tl.weight, torch.full_like(tl.weight, 0.5))
