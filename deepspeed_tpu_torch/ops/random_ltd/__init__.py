"""Random-LTD token-dropping ops (counterpart of
``deepspeed_tpu/ops/random_ltd``): sampling, ``token_sort_``,
``token_gather`` and ``token_scatter_``. The module that wraps a layer is
``runtime/data_pipeline/data_routing/basic_layer.py``
(``RandomLayerTokenDrop``)."""

from deepspeed_tpu_torch.ops.random_ltd.dropping_utils import (bert_sample_tokens,
                                                               gpt_sample_tokens, token_gather,
                                                               token_scatter_, token_sort_)

__all__ = ["gpt_sample_tokens", "bert_sample_tokens", "token_sort_", "token_gather",
           "token_scatter_"]
