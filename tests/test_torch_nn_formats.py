"""The nn surface slice 1b adds, held against the JAX package on the CPU
from the same numpy inputs (f32; atol 1e-5 + rtol 1e-5 for the
convolutions, whose sums XLA and PyTorch order differently; the pools
and the losses' elementwise steps within 1e-6).

- ``F.conv2d`` over NCHW and NHWC, with int, "SAME" and "VALID" padding
  at strides 1 and 2 and dilation 2 (``jax.lax.padtype_to_pads``: the
  odd pixel at the end), odd and even sizes; ``Conv2D`` with
  ``data_format="NHWC"`` and with every ``padding_mode`` (zeros whatever
  the mode, as the JAX layer).
- ``F.max_pool2d`` over NCHW and NHWC with "SAME"/"VALID" at strides 1
  and 2 and ``ceil_mode``; ``return_mask=True`` returns the pooled
  tensor only; the ``MaxPool2D`` layer pools NCHW whatever its
  ``data_format``, as JAX's; ``F.adaptive_avg_pool2d`` and
  ``AdaptiveAvgPool2D`` over NHWC, dividing and not.
- ``F.cross_entropy`` / ``CrossEntropyLoss``: every branch of the JAX
  function (hard labels with and without a trailing 1, ``ignore_index``,
  class ``weight`` with the weighted mean, ``reduction`` "none" and
  "sum", ``soft_label``, ``axis=1``, ``use_softmax=False``,
  ``label_smoothing``), values and input gradients; its errors for
  float hard labels and bad label shapes.

About 20 s on one core.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.layer import load_numpy_state


def _np(x):
    return np.asarray(x.value if hasattr(x, "value") else x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return paddle.to_tensor(np.array(x))


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("padding,stride,dilation", [
    (1, 1, 1), ("SAME", 1, 1), ("SAME", 2, 1), ("VALID", 2, 1),
    ("SAME", 2, 2), ([(0, 1), (2, 1)], 2, 1)])
def test_conv2d_formats_and_padding_match_jax(fmt, padding, stride,
                                              dilation):
    rng = np.random.RandomState(0)
    shape = (2, 3, 9, 8) if fmt == "NCHW" else (2, 9, 8, 3)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(4, 3, 3, 2).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    want = _np(JF.conv2d(_j(x), _j(w), _j(b), stride, padding, dilation,
                         data_format=fmt))
    got = TF.conv2d(_t(x), _t(w), _t(b), stride, padding, dilation,
                    data_format=fmt)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["zeros", "reflect", "circular"])
def test_conv2d_layer_nhwc_and_padding_modes_match_jax(mode):
    paddle.seed(0)
    jl = jnn.Conv2D(3, 4, 3, padding=1, padding_mode=mode,
                    data_format="NHWC")
    tl = tnn.Conv2D(3, 4, 3, padding=1, padding_mode=mode,
                    data_format="NHWC", device="cpu")
    load_numpy_state(tl, {k: v.numpy() for k, v in jl.state_dict().items()})
    x = np.random.RandomState(1).randn(2, 6, 5, 3).astype(np.float32)
    np.testing.assert_allclose(tl(_t(x)).detach().numpy(), _np(jl(_j(x))),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kernel,stride,padding,ceil", [
    (3, 1, "SAME", False), (3, 2, "SAME", False), (2, 2, "VALID", False),
    (3, 2, "SAME", True), (3, 2, 1, True)])
def test_max_pool2d_formats_and_padding_match_jax(fmt, kernel, stride,
                                                  padding, ceil):
    rng = np.random.RandomState(2)
    shape = (2, 3, 9, 8) if fmt == "NCHW" else (2, 9, 8, 3)
    x = rng.randn(*shape).astype(np.float32)
    want = _np(JF.max_pool2d(_j(x), kernel, stride, padding, ceil,
                             data_format=fmt))
    got = TF.max_pool2d(_t(x), kernel, stride, padding, ceil,
                        data_format=fmt)
    np.testing.assert_array_equal(got.numpy(), want)
    masked = TF.max_pool2d(_t(x), kernel, stride, padding, ceil,
                           return_mask=True, data_format=fmt)
    assert torch.is_tensor(masked) and torch.equal(masked, got)


def test_max_pool_layer_ignores_mask_and_format_as_jax():
    x = np.random.RandomState(3).randn(2, 4, 6, 6).astype(np.float32)
    jl = jnn.MaxPool2D(2, 2, return_mask=True, data_format="NHWC")
    tl = tnn.MaxPool2D(2, 2, return_mask=True, data_format="NHWC")
    np.testing.assert_array_equal(tl(_t(x)).numpy(), _np(jl(_j(x))))
    assert tuple(tl(_t(x)).shape) == (2, 4, 3, 3)


@pytest.mark.parametrize("size", [1, 2, (3, 4), (7, 3)])
def test_adaptive_avg_pool2d_nhwc_matches_jax(size):
    x = np.random.RandomState(4).randn(2, 7, 8, 3).astype(np.float32)
    want = _np(JF.adaptive_avg_pool2d(_j(x), size, data_format="NHWC"))
    got = TF.adaptive_avg_pool2d(_t(x), size, data_format="NHWC")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    layer = tnn.AdaptiveAvgPool2D(size, data_format="NHWC")
    np.testing.assert_array_equal(layer(_t(x)).numpy(), got.numpy())


def _xent_case(name):
    """(logits, label, kwargs) of one branch of cross_entropy."""
    rng = np.random.RandomState(5)
    x = rng.randn(6, 5).astype(np.float32) * 2
    lab = np.array([0, 4, 2, -100, 1, 3], np.int64)
    w = np.array([0.5, 1.0, 2.0, 1.5, 0.25], np.float32)
    soft = rng.rand(6, 5).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    return {
        "mean": (x, lab, {}),
        "trailing_one": (x, lab[:, None], {}),
        "weight_mean": (x, lab, {"weight": w}),
        "weight_sum": (x, lab, {"weight": w, "reduction": "sum"}),
        "none": (x, lab, {"reduction": "none"}),
        "sum": (x, lab, {"reduction": "sum"}),
        "soft": (x, soft, {"soft_label": True}),
        "soft_none": (x, soft, {"soft_label": True, "reduction": "none"}),
        "axis1": (np.ascontiguousarray(rng.randn(3, 5, 4).astype(
            np.float32)), np.array([[0, 1, 2, 3], [4, 4, 0, 1],
                                    [2, 3, -100, 0]], np.int64),
                  {"axis": 1}),
        "no_softmax": (rng.rand(6, 5).astype(np.float32), lab,
                       {"use_softmax": False}),
        "smoothing": (x, lab, {"label_smoothing": 0.1}),
        "smoothing_weight": (x, lab, {"label_smoothing": 0.2, "weight": w}),
    }[name]


XENT_CASES = ["mean", "trailing_one", "weight_mean", "weight_sum", "none",
              "sum", "soft", "soft_none", "axis1", "no_softmax", "smoothing",
              "smoothing_weight"]


@pytest.mark.parametrize("name", XENT_CASES)
def test_cross_entropy_branches_match_jax(name):
    x, lab, kw = _xent_case(name)
    jkw = dict(kw, **({"weight": jnp.asarray(kw["weight"])}
                      if "weight" in kw else {}))
    want = _np(JF.cross_entropy(_j(x), _j(lab), **jkw))
    jx = paddle.to_tensor(x, stop_gradient=False)
    paddle.sum(JF.cross_entropy(jx, _j(lab), **jkw)).backward()
    jgrad = _np(jx.grad)
    tkw = dict(kw, **({"weight": _t(kw["weight"])} if "weight" in kw
                      else {}))
    tx = _t(x).requires_grad_(True)
    got = TF.cross_entropy(tx, _t(lab), **tkw)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), jgrad, atol=1e-6, rtol=1e-6)
    layer = tnn.CrossEntropyLoss(**tkw)
    np.testing.assert_array_equal(layer(_t(x), _t(lab)).detach().numpy(),
                                  got.detach().numpy())


def test_cross_entropy_errors():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="integer class ids"):
        TF.cross_entropy(x, torch.zeros(4))
    with pytest.raises(ValueError, match="without the class axis"):
        TF.cross_entropy(x, torch.zeros(4, 3, 2, dtype=torch.int64))
    with pytest.raises(ValueError, match="size is not 1"):
        TF.cross_entropy(x, torch.zeros(4, 3, dtype=torch.int64))
