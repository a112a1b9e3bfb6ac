from .gpt import GPTConfig, GPTForCausalLM

__all__ = ["GPTConfig", "GPTForCausalLM"]
