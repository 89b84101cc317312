"""K3's static forms in the port against the JAX package on the CPU.

The plain versions of the static sgd, momentum, adam and lamb updates
(``paddle_tpu_torch/ops/cuda/fused_optimizer.py`` ``static_*_``, which
run their plain version on CPU tensors) against ``fused_op_update``, the
static ops' delegate, with the Pallas kernels forced into interpret mode,
and against the XLA references ``_XLA[op]``; at n = 100 (below one
(8, 128) tile: JAX's XLA route) and n = 3000 (padded tiles: the Pallas
route), with FoundInfinite absent, false and true. The list forms
(``static_*_list_``: a run of update ops, as the executor hands it over,
one launch on the card) over a run of mixed sizes, lengths that are not
multiples of 4 among them: against ``fused_op_update`` and ``_XLA[op]``
called op by op, and bit for bit against the per-op plain versions. The
CUDA kernels are held bit for bit against these plain versions on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances: atol 1e-7 + rtol 1e-6 for sgd, momentum and adam (XLA's CPU
backend may fuse a product and a sum into one FMA where the port rounds
each); rtol 1e-5 for lamb (the norms sum in another order), with an
absolute floor of 1e-5 of the tensor's largest value where the update
cancels the parameter.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import counters as jcounters
from paddle_tpu.ops.pallas import fused_optimizer as jfo
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.ops.cuda import fused_optimizer as tfo

OPS = {
    "sgd": {},
    "momentum": {"mu": 0.9, "use_nesterov": False},
    "nesterov": {"mu": 0.9, "use_nesterov": True},
    "adam": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
    "lamb": {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
             "weight_decay": 0.01},
}
SHAPES = {100: (100,), 3000: (50, 60)}
FOUND = {"absent": None, "false": False, "true": True}


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    """Run pallas_call in interpret mode, and let fused_op_update take
    the Pallas route on the CPU."""
    from jax.experimental import pallas as pl

    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(real, interpret=True))
    monkeypatch.setenv("PADDLE_FUSED_OPT_INTERPRET", "1")
    counters.reset()
    yield
    counters.reset()


def _inputs(op, shape, found, seed):
    """The op's input slots as numpy arrays, from non-zero state."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    ins = {"Param": rng.randn(*shape).astype(f32) * f32(0.5),
           "Grad": rng.randn(*shape).astype(f32) * f32(0.1),
           "LearningRate": np.array([0.05], f32)}
    if op in ("momentum", "nesterov"):
        ins["Velocity"] = rng.randn(*shape).astype(f32) * f32(0.05)
    if op in ("adam", "lamb"):
        ins["Moment1"] = rng.randn(*shape).astype(f32) * f32(0.01)
        ins["Moment2"] = np.abs(rng.randn(*shape)).astype(f32) * f32(1e-3)
        ins["Beta1Pow"] = np.array([0.9 ** 3], f32)
        ins["Beta2Pow"] = np.array([0.999 ** 3], f32)
    if found is not None:
        ins["FoundInfinite"] = np.array([found])
    return ins


def _port(op, ins, attrs):
    """The port's static op on CPU tensors: {out slot: ndarray}."""
    t = {k: torch.tensor(v) for k, v in ins.items()}
    found = t.get("FoundInfinite")
    p, g, lr = t["Param"], t["Grad"], t["LearningRate"]
    if op == "sgd":
        tfo.static_sgd_(p, g, lr, found)
        return {"ParamOut": p.numpy()}
    if op in ("momentum", "nesterov"):
        tfo.static_momentum_(p, g, t["Velocity"], lr, mu=attrs["mu"],
                             nesterov=attrs["use_nesterov"], found=found)
        return {"ParamOut": p.numpy(), "VelocityOut": t["Velocity"].numpy()}
    update = tfo.static_adam_ if op == "adam" else tfo.static_lamb_
    extra = {"weight_decay": attrs["weight_decay"]} if op == "lamb" else {}
    b1p, b2p = update(p, g, t["Moment1"], t["Moment2"], t["Beta1Pow"],
                      t["Beta2Pow"], lr, beta1=attrs["beta1"],
                      beta2=attrs["beta2"], eps=attrs["epsilon"],
                      found=found, **extra)
    return {"ParamOut": p.numpy(), "Moment1Out": t["Moment1"].numpy(),
            "Moment2Out": t["Moment2"].numpy(), "Beta1PowOut": b1p.numpy(),
            "Beta2PowOut": b2p.numpy()}


def _jax_ins(ins):
    return {k: [jnp.asarray(v)] for k, v in ins.items()}


def _assert_close(got, want, op):
    assert set(got) == set(want)
    for slot, w in want.items():
        w = np.asarray(w[0])
        # lamb: rtol 1e-5 of each value and of the tensor's largest (a
        # last-bit difference of the trust ratio shows as a large
        # relative error where p - lr*trust*r cancels)
        rtol, atol = (1e-5, 1e-5 * float(np.abs(w).max())) \
            if op == "lamb" else (1e-6, 1e-7)
        if slot.endswith("PowOut"):
            # the Pallas route returns the pows 0-dim (b1p.reshape(())),
            # the XLA route (1,) as the variable is declared; the port
            # keeps (1,)
            assert got[slot].shape == (1,), slot
            w = w.reshape(1)
        assert got[slot].shape == w.shape, slot
        np.testing.assert_allclose(got[slot], w, rtol=rtol, atol=atol,
                                   err_msg=slot)


@pytest.mark.parametrize("found", list(FOUND), ids=list(FOUND))
@pytest.mark.parametrize("n", list(SHAPES))
@pytest.mark.parametrize("op", list(OPS))
def test_static_plain_matches_fused_op_update(op, n, found):
    attrs = OPS[op]
    jop = "momentum" if op == "nesterov" else op
    ins = _inputs(op, SHAPES[n], FOUND[found], seed=n)
    before = jcounters.snapshot()
    want = jfo.fused_op_update(jop, _jax_ins(ins), attrs)
    path = "pallas" if n >= 1024 else "xla"
    assert jcounters.delta(before).get(f"fused_opt.{path}", 0) == 1
    got = _port(op, ins, attrs)
    _assert_close(got, want, op)
    assert counters.snapshot() == {}                  # the CPU runs plain


@pytest.mark.parametrize("found", list(FOUND), ids=list(FOUND))
@pytest.mark.parametrize("n", list(SHAPES))
@pytest.mark.parametrize("op", list(OPS))
def test_static_plain_matches_xla_reference(op, n, found):
    attrs = OPS[op]
    jop = "momentum" if op == "nesterov" else op
    ins = _inputs(op, SHAPES[n], FOUND[found], seed=7 * n)
    want = jfo._XLA[jop](_jax_ins(ins), attrs)
    _assert_close(_port(op, ins, attrs), want, op)


@pytest.mark.parametrize("op", list(OPS))
def test_a_found_infinite_step_keeps_every_state_bitwise(op):
    """The gate holds p, the moments or velocity and the beta-pows
    exactly; without the flag the beta-pows advance by b1, b2."""
    attrs = OPS[op]
    ins = _inputs(op, (40, 7), True, seed=3)
    got = _port(op, ins, attrs)
    olds = {"ParamOut": "Param", "VelocityOut": "Velocity",
            "Moment1Out": "Moment1", "Moment2Out": "Moment2",
            "Beta1PowOut": "Beta1Pow", "Beta2PowOut": "Beta2Pow"}
    for slot, arr in got.items():
        np.testing.assert_array_equal(arr, ins[olds[slot]], err_msg=slot)
    if op in ("adam", "lamb"):
        ins = _inputs(op, (40, 7), False, seed=3)
        got = _port(op, ins, attrs)
        assert got["Beta1PowOut"][0] == np.float32(ins["Beta1Pow"][0]
                                                   * np.float32(0.9))
        assert got["Beta2PowOut"][0] == np.float32(ins["Beta2Pow"][0]
                                                   * np.float32(0.999))


def test_lamb_trust_is_one_for_a_zero_parameter():
    """A zero parameter (a bias at initialisation) takes trust 1 and
    stays finite, as in ``_xla_lamb``."""
    attrs = OPS["lamb"]
    ins = _inputs("lamb", (64,), None, seed=5)
    ins["Param"][:] = 0.0
    got = _port("lamb", ins, attrs)
    want = jfo._XLA["lamb"](_jax_ins(ins), attrs)
    assert np.isfinite(got["ParamOut"]).all()
    _assert_close(got, want, "lamb")


def test_static_wrappers_raise_on_what_they_do_not_take():
    p = torch.zeros(4)
    with pytest.raises(ValueError, match="f32"):
        tfo.static_sgd_(p, torch.zeros(4, dtype=torch.float64),
                        torch.ones(1))
    with pytest.raises(ValueError, match="shape"):
        tfo.static_sgd_(p, torch.zeros(5), torch.ones(1))
    with pytest.raises(ValueError, match="lr"):
        tfo.static_sgd_(p, torch.zeros(4), torch.ones(2))
    with pytest.raises(ValueError, match="FoundInfinite"):
        tfo.static_sgd_(p, torch.zeros(4), torch.ones(1),
                        found=torch.zeros(1))
    with pytest.raises(ValueError, match="no elements"):
        tfo.static_sgd_(torch.zeros(0), torch.zeros(0), torch.ones(1))


# ---------------------------------------------------------------------------
# runs: the list forms the executor calls for consecutive update ops
# ---------------------------------------------------------------------------
RUN_SHAPES = [(1,), (7,), (13, 3), (100,), (50, 60), (1025,), (4099,), (2,)]


def _run_inputs(op, found, seed):
    """One ``_inputs`` dict an op of a run over RUN_SHAPES; ``found``
    "mixed" sets the flag on every third op."""
    return [_inputs(op, shape,
                    (k % 3 == 0) if found == "mixed" else FOUND[found],
                    seed=seed + k)
            for k, shape in enumerate(RUN_SHAPES)]


def _port_run(op, run, attrs):
    """The list form over the run's ops on CPU tensors: [{out slot:
    ndarray}] in op order."""
    ts = [{k: torch.tensor(v) for k, v in ins.items()} for ins in run]

    def col(k):
        return [t[k] for t in ts]
    founds = [t.get("FoundInfinite") for t in ts]
    p, g, lr = col("Param"), col("Grad"), col("LearningRate")
    if op == "sgd":
        tfo.static_sgd_list_(p, g, lr, founds)
        return [{"ParamOut": t["Param"].numpy()} for t in ts]
    if op in ("momentum", "nesterov"):
        tfo.static_momentum_list_(p, g, col("Velocity"), lr, mu=attrs["mu"],
                                  nesterov=attrs["use_nesterov"],
                                  founds=founds)
        return [{"ParamOut": t["Param"].numpy(),
                 "VelocityOut": t["Velocity"].numpy()} for t in ts]
    update = tfo.static_adam_list_ if op == "adam" else tfo.static_lamb_list_
    extra = {"weight_decay": attrs["weight_decay"]} if op == "lamb" else {}
    pows = update(p, g, col("Moment1"), col("Moment2"), col("Beta1Pow"),
                  col("Beta2Pow"), lr, beta1=attrs["beta1"],
                  beta2=attrs["beta2"], eps=attrs["epsilon"], founds=founds,
                  **extra)
    return [{"ParamOut": t["Param"].numpy(),
             "Moment1Out": t["Moment1"].numpy(),
             "Moment2Out": t["Moment2"].numpy(),
             "Beta1PowOut": b1p.numpy(), "Beta2PowOut": b2p.numpy()}
            for t, (b1p, b2p) in zip(ts, pows)]


@pytest.mark.parametrize("route", ["fused_op_update", "xla"])
@pytest.mark.parametrize("found", list(FOUND) + ["mixed"])
@pytest.mark.parametrize("op", list(OPS))
def test_static_run_matches_jax_op_by_op(op, found, route):
    """The run's list form against the JAX package's update of each op
    on its own: ``fused_op_update`` (the Pallas kernel in interpret mode
    for the ops of 1024 or more elements, its XLA route below) or the
    XLA reference ``_XLA[op]``; each op's outputs to the tolerances of
    the one-op tests."""
    attrs = OPS[op]
    jop = "momentum" if op == "nesterov" else op
    run = _run_inputs(op, found, seed=11)
    got = _port_run(op, run, attrs)
    for ins, g in zip(run, got):
        want = (jfo.fused_op_update(jop, _jax_ins(ins), attrs)
                if route == "fused_op_update"
                else jfo._XLA[jop](_jax_ins(ins), attrs))
        _assert_close(g, want, op)
    assert counters.snapshot() == {}                  # the CPU runs plain


@pytest.mark.parametrize("found", list(FOUND) + ["mixed"])
@pytest.mark.parametrize("op", list(OPS))
def test_static_run_is_bitwise_the_per_op_plain_versions(op, found):
    """The list form's plain version is the loop of the one-op forms:
    every output bit for bit, the flagged ops' state unchanged."""
    attrs = OPS[op]
    run = _run_inputs(op, found, seed=23)
    got = _port_run(op, run, attrs)
    for ins, g in zip(run, got):
        want = _port(op, ins, attrs)
        assert set(g) == set(want)
        for slot in want:
            np.testing.assert_array_equal(g[slot], want[slot], err_msg=slot)
        if "FoundInfinite" in ins and ins["FoundInfinite"][0]:
            np.testing.assert_array_equal(g["ParamOut"], ins["Param"])


def test_static_list_forms_raise_on_what_they_do_not_take():
    p = [torch.zeros(4), torch.zeros(3)]
    lr = [torch.ones(1), torch.ones(1)]
    with pytest.raises(ValueError, match="different lengths"):
        tfo.static_sgd_list_(p, p[:1], lr)
    with pytest.raises(ValueError, match="different lengths"):
        tfo.static_sgd_list_(p, p, lr, founds=[None])
    with pytest.raises(ValueError, match="empty run"):
        tfo.static_sgd_list_([], [], [])
    with pytest.raises(ValueError, match="shape"):
        tfo.static_sgd_list_(p, [torch.zeros(4), torch.zeros(4)], lr)
    with pytest.raises(ValueError, match="FoundInfinite"):
        tfo.static_momentum_list_(p, p, p, lr, mu=0.9,
                                  founds=[None, torch.zeros(1)])
