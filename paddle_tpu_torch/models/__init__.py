from .bert import (BertConfig, BertForPretraining, BertModel,
                   BertPretrainingCriterion)
from .gpt import GPTConfig, GPTForCausalLM, GPTPretrainingCriterion

__all__ = ["BertConfig", "BertForPretraining", "BertModel",
           "BertPretrainingCriterion", "GPTConfig", "GPTForCausalLM",
           "GPTPretrainingCriterion"]
