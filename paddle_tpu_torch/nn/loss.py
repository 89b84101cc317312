"""``CrossEntropyLoss`` (port of ``paddle_tpu/nn/loss.py``): the mean
hard-label softmax cross-entropy over the last axis, rows labelled
``ignore_index`` left out of the sum and the count."""
from __future__ import annotations

from . import functional as F
from .layer import Layer

__all__ = ["CrossEntropyLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0):
        super().__init__()
        if weight is not None or reduction != "mean" or soft_label \
                or axis != -1 or not use_softmax or label_smoothing:
            raise NotImplementedError(
                "CrossEntropyLoss: class weights, other reductions, soft "
                "labels, another axis, use_softmax=False and label "
                "smoothing are a later port slice")
        self.ignore_index = ignore_index

    def forward(self, input, label):
        return F.cross_entropy(input, label, ignore_index=self.ignore_index)
