from deepspeed_tpu_torch.ops.adagrad.adagrad import Adagrad  # noqa: F401
