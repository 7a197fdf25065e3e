"""Model family of the port (the GPT decoder, the bidirectional encoder and
its classifier, the encoder-decoder, KV-cache generation, int8 weight
export, HuggingFace interop in ``models/hf.py``)."""

from tpu_parallel_torch.models.gpt import (GPTLM, EncoderClassifier, GPTConfig, bert_base,
                                           bert_base_hf, gpt2_125m, llama_1b, make_mlm_loss,
                                           tiny_test)
from tpu_parallel_torch.models.hf import (from_hf_bert, from_hf_gpt2, from_hf_llama, from_hf_t5,
                                          to_hf_bert, to_hf_gpt2, to_hf_llama, to_hf_t5)
from tpu_parallel_torch.models.layers import RelativePositionBias, TransformerConfig
from tpu_parallel_torch.models.quantize import (
    QuantizedTensor,
    dequantize_params,
    quantize_params,
    quantized_nbytes,
)
from tpu_parallel_torch.models.seq2seq import (EncoderDecoder, Seq2SeqBatch, Seq2SeqConfig,
                                               make_seq2seq_loss, seq2seq_generate,
                                               seq2seq_generate_beam, seq2seq_generate_sharded,
                                               t5_small, t5_small_hf, tiny_seq2seq)

__all__ = ["EncoderClassifier", "EncoderDecoder", "GPTLM", "GPTConfig", "QuantizedTensor",
           "RelativePositionBias", "Seq2SeqBatch", "Seq2SeqConfig", "TransformerConfig",
           "bert_base", "bert_base_hf", "dequantize_params", "from_hf_bert", "from_hf_gpt2",
           "from_hf_llama", "from_hf_t5", "gpt2_125m", "llama_1b", "make_mlm_loss",
           "make_seq2seq_loss", "quantize_params", "quantized_nbytes", "seq2seq_generate",
           "seq2seq_generate_beam", "seq2seq_generate_sharded", "t5_small", "t5_small_hf",
           "tiny_seq2seq", "tiny_test", "to_hf_bert", "to_hf_gpt2", "to_hf_llama", "to_hf_t5"]
