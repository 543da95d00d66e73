"""PyTorch/CUDA port of the ``deepspeed_tpu`` serving path and training
step (GPT-2, the LLaMA family and BERT) for NVIDIA Hopper GPUs.

The JAX package stays the reference; this package imports neither it nor
JAX. Its entry points run on CUDA unless the caller passes ``device="cpu"``,
where every kernel wrapper computes its plain PyTorch version."""

from deepspeed_tpu_torch.device import resolve_device
from deepspeed_tpu_torch.inference import DeepSpeedInferenceConfig, InferenceEngine, init_inference
from deepspeed_tpu_torch.models.bert import BertConfig, BertForMaskedLM, get_bert_config
from deepspeed_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel, get_gpt2_config
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, get_llama_config
from deepspeed_tpu_torch.ops.transformer import DeepSpeedTransformerConfig, DeepSpeedTransformerLayer
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.runtime.entry import initialize
from deepspeed_tpu_torch.runtime.hybrid_engine import DeepSpeedHybridEngine

__all__ = ["BertConfig", "BertForMaskedLM", "DeepSpeedConfig", "DeepSpeedEngine",
           "DeepSpeedHybridEngine", "DeepSpeedInferenceConfig", "DeepSpeedTransformerConfig",
           "DeepSpeedTransformerLayer", "GPT2Config",
           "GPT2LMHeadModel", "InferenceEngine", "LlamaConfig", "LlamaForCausalLM",
           "get_bert_config", "get_gpt2_config", "get_llama_config", "init_inference", "initialize",
           "resolve_device"]
