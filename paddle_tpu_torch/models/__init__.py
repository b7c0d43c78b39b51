from .gpt import (GPTConfig, GPTForCausalLM, GPTModel, GPTPretrainingCriterion,
                  gpt3_1p3b, gpt3_6p7b, gpt3_13b, gpt3_125m, gpt3_350m,
                  gpt3_tiny)

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel", "GPTPretrainingCriterion",
           "gpt3_tiny", "gpt3_125m", "gpt3_350m", "gpt3_1p3b", "gpt3_6p7b",
           "gpt3_13b"]
