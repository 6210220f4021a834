from .bert import (Bert, BertConfig, BertForPretraining, bert_base,
                   bert_pretrain_loss_fn, ernie_large)
from .gpt import GPT, GPTConfig, gpt_loss_fn

__all__ = ["GPT", "GPTConfig", "gpt_loss_fn", "Bert", "BertConfig",
           "BertForPretraining", "bert_base", "bert_pretrain_loss_fn",
           "ernie_large"]
