"""The process-wide launch counters (``ops/cuda/counters.py``) across
tests that share one process, as pytest-xdist runs them: a counted
refusal left by one test must not break another test's "the CPU runs
plain" check. Port only (no JAX): the data-parallel test net from
``tests/_torch_zero_ranks.py`` on the CPU."""
from __future__ import annotations

import numpy as np

import paddle_tpu_torch.static as ts
from paddle_tpu_torch.ops.cuda import counters
from paddle_tpu_torch.utils import unique_name as tun

import _torch_zero_ranks as ranks

REFUSED = [{"comm_quant": "int8", "zero_stage": 2}]


def _counted_since(before):
    return {k: n - before.get(k, 0) for k, n in counters.snapshot().items()
            if n != before.get(k, 0)}


def _feed():
    rng = np.random.RandomState(5)
    return {"x": rng.randn(16, 16).astype(np.float32),
            "label": rng.randint(0, 4, (16, 1)).astype(np.int64)}


def _steps(legs, steps=2):
    """``steps`` steps a leg of the dp net from its own startup state on
    a fresh CPU executor; the losses."""
    _main, startup, _loss, _ = ranks.dp_net(ts, tun, "momentum")
    scope, exe = ts.Scope(), ts.Executor(ts.CPUPlace())
    exe.run(startup, scope=scope)
    return ranks.run_legs(ts, tun, exe, scope, "dp_net", "momentum",
                          _feed(), legs, steps, 1)[0]


def test_a_counted_refusal_then_a_plain_run():
    """The sequence that used to leak: a one-rank CompiledProgram asked
    for comm_quant and ZeRO counts its refusals, then a plain run on the
    CPU checks that it launched nothing. The check reads only the plain
    run's own counts, so it holds whatever ran before it."""
    counters.reset()
    try:
        _steps(REFUSED)
        left = counters.snapshot()
        assert left == {"quant_allreduce.xla": 1, "zero.xla": 1}
        before = counters.snapshot()
        losses = _steps([None])
        assert _counted_since(before) == {}         # the CPU runs plain
        assert counters.snapshot() == left          # and counts nothing
        assert all(np.isfinite(losses))
    finally:
        counters.reset()

