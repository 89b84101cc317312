"""Models of the port; so far BERT pretraining (``models.bert``)."""
from . import bert

__all__ = ["bert"]
