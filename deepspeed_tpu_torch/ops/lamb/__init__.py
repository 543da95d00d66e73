from deepspeed_tpu_torch.ops.lamb.fused_lamb import FusedLamb  # noqa: F401
