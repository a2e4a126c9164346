"""Model families of the port (counterpart of ``paddle_tpu/models``):
GPT at degree 1 and Llama."""
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  GPTPretrainingCriterion, gpt_125m, gpt_13b, gpt_1p3b,
                  gpt_350m, gpt_tiny)
from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,  # noqa: F401
                    LlamaPretrainingCriterion, llama_13b, llama_7b,
                    llama_tiny, llama_tiny_draft)

__all__ = ["GPTConfig", "GPTModel", "GPTForCausalLM",
           "GPTPretrainingCriterion", "gpt_tiny", "gpt_125m", "gpt_350m",
           "gpt_1p3b", "gpt_13b", "LlamaConfig", "LlamaModel",
           "LlamaForCausalLM", "LlamaPretrainingCriterion", "llama_tiny",
           "llama_tiny_draft", "llama_7b", "llama_13b"]
