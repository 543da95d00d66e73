"""Block-sparse attention (counterpart of ``deepspeed_tpu/ops/sparse_attention``)."""

from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention import (SparseSelfAttention,
                                                                            layout_index_lists,
                                                                            sparse_attention)
from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (BigBirdSparsityConfig,
                                                                      BSLongformerSparsityConfig,
                                                                      DenseSparsityConfig,
                                                                      FixedSparsityConfig,
                                                                      LocalSlidingWindowSparsityConfig,
                                                                      SparsityConfig,
                                                                      VariableSparsityConfig)

__all__ = ["SparsityConfig", "DenseSparsityConfig", "FixedSparsityConfig",
           "VariableSparsityConfig", "BigBirdSparsityConfig", "BSLongformerSparsityConfig",
           "LocalSlidingWindowSparsityConfig", "SparseSelfAttention", "sparse_attention",
           "layout_index_lists"]
