"""Mixed-precision helpers of the port's training engine (counterpart of
``deepspeed_tpu/runtime/fp16/``): the overflow watcher. Loss scaling waits
for fp16 training."""
