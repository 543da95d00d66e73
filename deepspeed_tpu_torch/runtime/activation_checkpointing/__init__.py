from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing import (  # noqa: F401
    POLICIES, CheckpointFunction, checkpoint, checkpoint_with_policy, configure,
    get_remat_policy, get_rng_state_tracker, is_configured, model_parallel_cuda_manual_seed,
    reset)
