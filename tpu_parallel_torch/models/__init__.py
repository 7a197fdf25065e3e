"""Model family of the port (GPT decoder, KV-cache generation)."""

from tpu_parallel_torch.models.gpt import GPTLM, GPTConfig, gpt2_125m, tiny_test
from tpu_parallel_torch.models.layers import TransformerConfig

__all__ = ["GPTLM", "GPTConfig", "TransformerConfig", "gpt2_125m", "tiny_test"]
