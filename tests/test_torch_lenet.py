"""The port's LeNet (paddle_tpu_torch.vision.models, BASELINE config 1)
trained as ``bench.py`` ``bench_mnist`` trains the JAX one (Adam lr
1e-3, cross-entropy, ``TrainStep``), held against the JAX package on
the CPU from the same weights (``load_numpy_state``) and numpy batch.
"""
import numpy as np
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.vision import models as jvm
from paddle_tpu_torch import nn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.vision import models as tvm


def test_lenet_three_adam_steps_match_jax():
    """LeNet as ``bench_mnist`` trains it (Adam lr 1e-3, cross-entropy),
    batch 8 x 1 x 28 x 28: three losses within rtol 1e-4."""
    paddle.seed(0)
    jm = jvm.LeNet(num_classes=10)
    tm = tvm.LeNet(num_classes=10, device="cpu")
    tvm.load_numpy_state(tm, {k: v.numpy()
                              for k, v in jm.state_dict().items()})
    jce, tce = jnn.CrossEntropyLoss(), nn.CrossEntropyLoss()
    jstep = JTrainStep(jm, lambda m, x, y: jce(m(x), y),
                       jopt.Adam(learning_rate=1e-3,
                                 parameters=jm.parameters()))
    tstep = TrainStep(tm, lambda m, x, y: tce(m(x), y),
                      Adam(learning_rate=1e-3, parameters=tm.parameters()))
    rng = np.random.RandomState(0)
    x = rng.randn(8, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, (8,)).astype(np.int64)
    jl = [float(jstep(paddle.to_tensor(x), paddle.to_tensor(y)).numpy())
          for _ in range(3)]
    tl = [float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_lenet_state_dict_matches_the_jax_model():
    paddle.seed(0)
    js = {k: tuple(v.shape) for k, v in jvm.LeNet().state_dict().items()}
    ts = {k: tuple(v.shape)
          for k, v in tvm.LeNet(device="cpu").state_dict().items()}
    assert js == ts
    assert len(ts) == 10
