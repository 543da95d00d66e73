from deepspeed_tpu_torch.models.gpt2 import GPT2_CONFIGS, GPT2Config, GPT2LMHeadModel, get_gpt2_config
from deepspeed_tpu_torch.models.llama import (LLAMA_CONFIGS, LlamaConfig, LlamaForCausalLM,
                                              get_llama_config)
from deepspeed_tpu_torch.models.bert import (BERT_CONFIGS, BertConfig, BertForMaskedLM, BertModel,
                                             bert_mlm_loss, get_bert_config)
from deepspeed_tpu_torch.models.opt import OPT_CONFIGS, OPTConfig, OPTForCausalLM, get_opt_config
from deepspeed_tpu_torch.models.gpt_neox import (GPT_NEOX_CONFIGS, GPTNeoXConfig, GPTNeoXForCausalLM,
                                                 get_gpt_neox_config)
from deepspeed_tpu_torch.models.bloom import (BLOOM_CONFIGS, BloomConfig, BloomForCausalLM,
                                              get_bloom_config)
from deepspeed_tpu_torch.models.falcon import (FALCON_CONFIGS, FalconConfig, FalconForCausalLM,
                                               get_falcon_config)
from deepspeed_tpu_torch.models.gptj import GPTJ_CONFIGS, GPTJConfig, GPTJForCausalLM, get_gptj_config
from deepspeed_tpu_torch.models.gpt_neo import (GPT_NEO_CONFIGS, GPTNeoConfig, GPTNeoForCausalLM,
                                                get_gpt_neo_config)
from deepspeed_tpu_torch.models.common import cross_entropy_loss
