from .gpt import GPTConfig, GPTForCausalLM, GPTPretrainingCriterion

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTPretrainingCriterion"]
