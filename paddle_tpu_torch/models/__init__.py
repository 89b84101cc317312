"""Models of the port: BERT pretraining (``models.bert``) and the GPT
causal LM (``models.gpt``)."""
from . import bert, gpt

__all__ = ["bert", "gpt"]
