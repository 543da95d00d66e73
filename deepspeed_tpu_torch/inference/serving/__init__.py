from deepspeed_tpu_torch.inference.serving.blocks import BlockPool
from deepspeed_tpu_torch.inference.serving.config import ServingConfig
from deepspeed_tpu_torch.inference.serving.queue import RequestQueue
from deepspeed_tpu_torch.inference.serving.request import (ACTIVE, FINISHED, PREFILL, QUEUED,
                                                           REFUSED, Request)
from deepspeed_tpu_torch.inference.serving.scheduler import ContinuousBatchingScheduler
