"""Model family of the port (GPT decoder, KV-cache generation, int8 weight
export)."""

from tpu_parallel_torch.models.gpt import GPTLM, GPTConfig, gpt2_125m, llama_1b, tiny_test
from tpu_parallel_torch.models.layers import TransformerConfig
from tpu_parallel_torch.models.quantize import (
    QuantizedTensor,
    dequantize_params,
    quantize_params,
    quantized_nbytes,
)

__all__ = ["GPTLM", "GPTConfig", "QuantizedTensor", "TransformerConfig", "dequantize_params",
           "gpt2_125m", "llama_1b", "quantize_params", "quantized_nbytes", "tiny_test"]
