from deepspeed_tpu_torch.ops.adam.fused_adam import FusedAdam
