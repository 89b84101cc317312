"""Models of the port: BERT pretraining (``models.bert``), the GPT
causal LM (``models.gpt``) and the Transformer NMT
(``models.transformer``)."""
from . import bert, gpt, transformer
from .bert import BertConfig, BertForPretraining, BertModel
from .gpt import GPTConfig, GPTForCausalLM, GPTModel
from .transformer import TransformerNMT

__all__ = ["bert", "gpt", "transformer", "BertConfig", "BertModel",
           "BertForPretraining", "GPTConfig", "GPTModel", "GPTForCausalLM",
           "TransformerNMT"]
