"""Model family of the port (the GPT decoder, the bidirectional encoder and
its classifier, KV-cache generation, int8 weight export, HuggingFace
interop in ``models/hf.py``)."""

from tpu_parallel_torch.models.gpt import (GPTLM, EncoderClassifier, GPTConfig, bert_base,
                                           bert_base_hf, gpt2_125m, llama_1b, make_mlm_loss,
                                           tiny_test)
from tpu_parallel_torch.models.hf import (from_hf_bert, from_hf_gpt2, from_hf_llama, to_hf_bert,
                                          to_hf_gpt2, to_hf_llama)
from tpu_parallel_torch.models.layers import TransformerConfig
from tpu_parallel_torch.models.quantize import (
    QuantizedTensor,
    dequantize_params,
    quantize_params,
    quantized_nbytes,
)

__all__ = ["EncoderClassifier", "GPTLM", "GPTConfig", "QuantizedTensor", "TransformerConfig",
           "bert_base", "bert_base_hf", "dequantize_params", "from_hf_bert", "from_hf_gpt2",
           "from_hf_llama", "gpt2_125m", "llama_1b", "make_mlm_loss", "quantize_params",
           "quantized_nbytes", "tiny_test", "to_hf_bert", "to_hf_gpt2", "to_hf_llama"]
