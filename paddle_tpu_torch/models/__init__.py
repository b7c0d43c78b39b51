from .bert import (BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel,
                   BertPretrainingCriterion, bert_base, bert_tiny)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, GPTPretrainingCriterion,
                  gpt3_1p3b, gpt3_6p7b, gpt3_13b, gpt3_125m, gpt3_350m,
                  gpt3_tiny)
from .gpt_pipe import (GPTForCausalLMPipe, stack_layered_state_dict,
                       unstack_to_layered_state_dict)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel, llama_7b,
                    llama_13b, llama_tiny)
from .unet import UNetConfig, UNetModel, timestep_embedding, unet_tiny

__all__ = ["BertConfig", "BertForPretraining", "BertForSequenceClassification",
           "BertModel", "BertPretrainingCriterion", "bert_base", "bert_tiny",
           "GPTConfig", "GPTForCausalLM", "GPTModel", "GPTPretrainingCriterion",
           "gpt3_tiny", "gpt3_125m", "gpt3_350m", "gpt3_1p3b", "gpt3_6p7b",
           "gpt3_13b", "LlamaConfig", "LlamaForCausalLM", "LlamaModel",
           "llama_tiny", "llama_7b", "llama_13b", "GPTForCausalLMPipe",
           "stack_layered_state_dict", "unstack_to_layered_state_dict",
           "UNetConfig", "UNetModel", "timestep_embedding", "unet_tiny"]
