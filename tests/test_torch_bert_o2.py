"""Tiny BERT at AMP O2 (bf16 weights with f32 masters through
``amp.decorate``, ``jit.TrainStep``, AdamW) held against the JAX
package on the CPU.

Tiny BERT (``BertConfig.tiny()``), batch 2 x seq 128, dropout 0, AdamW
lr 1e-3 and weight decay 0.01, both models built under
``unique_name.guard()`` and the JAX weights carried into the port by
name, then ``decorate(level="O2", dtype="bfloat16")`` on each side.

- Three ``TrainStep`` losses against JAX's, rtol 2e-2 as at O1 (measured
  on one machine's CPU: equal, 8.5625, 6.71875, 6.375, every one a bf16
  value). On the CPU JAX's fused loss takes its XLA route
  (``fused_xent.py:405-412``), whose ``h @ W.T`` rounds the logits to
  bf16 before the f32 upcast, while the port's plain version (and the
  card's kernel) keeps the f32 accumulators: the tolerance absorbs
  that.
- The dtypes of trouble point 1 equal JAX's: every encoder layer's
  output (f32, a layer norm's), the MLM head's input (f32) and the loss
  (bf16: ``mlm + nsp`` is the ``add`` op, cast down under O2).
- The masters are the pre-decorate weights bit for bit, and after every
  step each bf16 parameter equals its master's cast.
- Every parameter keeps a master, and the step count equals JAX's.
  ``TransformerEncoder``'s copied layers share their parameter names in
  both packages, so the JAX optimizer's ``state_dict()`` keys hold one
  layer's slots for all of them; the port's ``state_dict`` and
  ``set_state_dict`` raise on such a list instead of loading one layer's
  master into every copy (the key scheme itself is held against JAX's
  on the small ResNet, whose names are unique).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.bert import BertConfig as JBertConfig
from paddle_tpu.models.bert import BertForPretraining as JBert
from paddle_tpu.utils import unique_name as jun
from paddle_tpu_torch import amp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.bert import (BertConfig, BertForPretraining,
                                          load_numpy_state)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.utils import unique_name as tun
from test_torch_bert import _batch, _no_dropout

STEPS = 3


def _decorated():
    paddle.seed(0)
    with jun.guard():
        jm = JBert(_no_dropout(JBertConfig.tiny()))
    with tun.guard():
        tm = BertForPretraining(_no_dropout(BertConfig.tiny()), device="cpu")
    load_numpy_state(tm, {k: v.numpy() for k, v in jm.state_dict().items()})
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters(),
                    weight_decay=0.01)
    to = AdamW(learning_rate=1e-3, parameters=tm.parameters(),
               weight_decay=0.01)
    jamp.decorate(jm, jo, level="O2", dtype="bfloat16")
    amp.decorate(tm, to, level="O2", dtype="bfloat16")
    return jm, tm, jo, to, before


def _jloss(m, *a):
    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        return m.loss(*a)


def _tloss(m, *a):
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        return m.loss(*a)


def test_o2_three_steps_match_jax_and_keep_the_master_invariants():
    jm, tm, jo, to, before = _decorated()
    for n, p in tm.named_parameters():
        assert p.dtype == torch.bfloat16
        assert torch.equal(to._slots[id(p)]["__master__"], before[n]), n
    jstep, tstep = JTrainStep(jm, _jloss, jo), TrainStep(tm, _tloss, to)
    batch = _batch()
    jargs = [paddle.to_tensor(x) for x in batch]
    targs = [torch.from_numpy(x) for x in batch]
    jl, tl = [], []
    for _ in range(STEPS):
        j, t = jstep(*jargs), tstep(*targs)
        assert str(j.dtype) == "bfloat16" and t.dtype == torch.bfloat16
        jl.append(float(j.numpy()))
        tl.append(float(t))
        for n, p in tm.named_parameters():
            master = to._slots[id(p)]["__master__"]
            assert p.dtype == torch.bfloat16 and master.dtype == torch.float32
            assert torch.equal(p, master.to(torch.bfloat16)), n
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    assert tl[-1] < tl[0]
    assert to._step_count == jo.state_dict()["step"] == STEPS
    assert all("__master__" in to._slots[id(p)] for p in tm.parameters())


def test_optimizer_state_of_shared_names_raises():
    """BERT's copied encoder layers share parameter names: a state dict
    keyed by name cannot hold them apart, so the round trip raises
    rather than give every layer one layer's master and moments."""
    _, tm, _, to, _ = _decorated()
    names = [p.name for p in tm.parameters()]
    assert len(set(names)) < len(names)
    with pytest.raises(ValueError, match="share the name"):
        to.state_dict()
    with pytest.raises(ValueError, match="share the name"):
        to.set_state_dict({"step": 1})


def test_o2_dtype_flow_matches_jax():
    jm, tm, _, _, _ = _decorated()
    ids, tt, mlm, nsp = _batch()
    ja = [paddle.to_tensor(x) for x in (ids, tt)]
    ta = [torch.from_numpy(x) for x in (ids, tt)]

    def name(t):
        return str(t.dtype).replace("torch.", "")

    with jamp.auto_cast(level="O2", dtype="bfloat16"):
        jx = jm.bert.embeddings(*ja)
        jflow = [name(jx)]
        for layer in jm.bert.encoder.layers:
            jx = layer(jx)
            jflow.append(name(jx))
        jflow.append(name(jm._mlm_hidden(jx)))
        jflow.append(name(jm.loss(*[paddle.to_tensor(x)
                                    for x in (ids, tt, mlm, nsp)])))
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        tx = tm.bert.embeddings(*ta)
        tflow = [name(tx)]
        for layer in tm.bert.encoder.layers:
            tx = layer(tx)
            tflow.append(name(tx))
        tflow.append(name(tm._mlm_hidden(tx)))
        tflow.append(name(tm.loss(*[torch.from_numpy(x)
                                    for x in (ids, tt, mlm, nsp)])))
    assert tflow == jflow
    assert tflow == ["float32"] * (len(tm.bert.encoder.layers) + 2) \
        + ["bfloat16"]
