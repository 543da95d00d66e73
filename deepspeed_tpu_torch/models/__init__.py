from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS, GPT2Config, GPT2LMHeadModel, get_gpt2_config
from deepspeed_tpu_torch.models.llama import (LLAMA_CONFIGS, LlamaConfig, LlamaForCausalLM,
                                              get_llama_config)
