"""Mixed-precision helpers of the port's training engine (counterpart of
``deepspeed_tpu/runtime/fp16/``): fp16 loss scaling and the overflow
watcher."""
