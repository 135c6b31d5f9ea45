"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``): the vision
nets and BERT."""
from . import bert, vision
from .bert import BERTModel, bert_base, bert_small, get_bert
from .vision import get_model

__all__ = ["BERTModel", "bert", "bert_base", "bert_small", "get_bert",
           "get_model", "vision"]
