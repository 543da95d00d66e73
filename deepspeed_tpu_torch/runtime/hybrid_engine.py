"""Hybrid (RLHF) engine: one engine that trains and serves ``generate()``
from the same weights (counterpart of
``deepspeed_tpu/runtime/hybrid_engine.py``, reference
``DeepSpeedHybridEngine``).

Serving runs on an inference view: an :class:`InferenceEngine` built over a
copy of the model in the compute dtype, with the training config's
attention backend (kernel injection off, as JAX builds it), so a model
trained on the ``"flash"`` backend serves on K1 and K3. The view is
refreshed from the live fp32 parameters after training moves them (a copy
into its tensors in place, cast on the way: ``runtime/rlhf/sync.py``),
never aliases them, and never draws from the training engine's generator,
so train -> generate -> train gives the same bits as train -> train.

LoRA: ``fuse_lora_weight`` / ``unfuse_lora_weight`` fold adapter pairs into
the view's copy of each kernel (``kernel + (lora_b @ lora_a).T *
lora_scaling``); the training parameters keep the adapters separate.
"""

import itertools
import logging
import os
import time
from typing import Dict, List, Optional

import torch

from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine

logger = logging.getLogger(__name__)

LORA_A = "lora_a"   # [rank, in]
LORA_B = "lora_b"   # [out, rank]
LORA_SCALING = "lora_scaling"
KERNEL = "kernel"


def fuse_lora_params(params: Dict[str, torch.Tensor], fuse: bool = True) -> Dict[str, torch.Tensor]:
    """A state dict where every ``<scope>.kernel`` with ``<scope>.lora_a``
    and ``<scope>.lora_b`` beside it has the adapter folded in (``fuse``)
    or is left as it is. Pure: ``params`` and its tensors are untouched."""
    out = dict(params)
    if not fuse:
        return out
    for name, kernel in params.items():
        scope, _, leaf = name.rpartition(".")
        prefix = f"{scope}." if scope else ""
        a, b = params.get(prefix + LORA_A), params.get(prefix + LORA_B)
        if leaf != KERNEL or a is None or b is None:
            continue
        scale = params.get(prefix + LORA_SCALING, 1.0)
        # kernels are [in, out]: delta = (b @ a).T
        delta = (b @ a).t().to(kernel.dtype) * scale
        out[name] = kernel + delta
    return out


class DeepSpeedHybridEngine(DeepSpeedEngine):
    """Trains like :class:`DeepSpeedEngine`; adds ``generate()``,
    ``infer_forward()`` and in-flight rollouts over an inference view of
    the live training parameters. ``telemetry`` (None) may be set to a
    ``RuntimeTelemetry`` for the rollout loop's learner and sync spans."""

    def __init__(self, model, config, **kwargs):
        if config.zero_config.offload_param_device != "none":
            raise NotImplementedError("the hybrid engine with offload_param (a serving view of "
                                      "host-resting parameters) belongs to a later slice of the "
                                      "PyTorch port (ROADMAP.md Queue A item 8)")
        super().__init__(model, config, **kwargs)
        self.he_config = config.hybrid_engine_config
        self.telemetry = None
        self._infer_engine = None
        self._infer_params_stale = True
        self.is_lora_fused = False
        # bookkeeping (reference hybrid_engine.py:55-63)
        self._generate_latency = 0.0
        self._training_latency = 0.0
        self._iters = 0
        self._gather_latency = 0.0
        # each train -> serve sync bumps the generation and stamps its evidence
        self.weight_sync_generation = 0
        self.last_weight_sync: Optional[dict] = None
        self.weight_sync_log: List[dict] = []

    # ------------------------------------------------------------------
    def train_batch(self, batch=None, data_iter=None) -> torch.Tensor:
        t0 = time.perf_counter()
        loss = super().train_batch(batch=batch, data_iter=data_iter)
        self._training_latency += time.perf_counter() - t0
        self._iters += 1
        return loss

    def step(self) -> None:
        super().step()
        self._infer_params_stale = True  # the parameters may have moved

    def load_checkpoint(self, *args, **kwargs):
        self._infer_params_stale = True
        return super().load_checkpoint(*args, **kwargs)

    # ------------------------------------------------------------------
    @property
    def compute_dtype(self) -> torch.dtype:
        return self.module.config.dtype

    def _inference_params_value(self) -> Dict[str, torch.Tensor]:
        """The live training parameters (no copy), LoRA-fused if asked."""
        params = self.module.state_dict()
        return fuse_lora_params(params) if self.is_lora_fused else params

    def _build_inference_engine(self):
        from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
        from deepspeed_tpu_torch.inference.engine import InferenceEngine

        icfg = DeepSpeedInferenceConfig(dtype=self.compute_dtype,
                                        max_tokens=self.he_config.max_out_tokens,
                                        replace_with_kernel_inject=False)
        engine = InferenceEngine(self.module, icfg, params=self._inference_params_value(),
                                 device=self.device)
        # injection serves a tensor already of the serving dtype as it is;
        # the view must not move with the training step until a sync, so it
        # takes a copy of those alone (a cast leaf is a new tensor already)
        live = {t.untyped_storage().data_ptr() for t in self.module.state_dict().values()}
        for t in itertools.chain(engine.module.parameters(), engine.module.buffers()):
            if t.untyped_storage().data_ptr() in live:
                t.data = t.data.clone()
        logger.info(f"hybrid engine: inference view ready (max_out_tokens="
                    f"{self.he_config.max_out_tokens}, backend "
                    f"{engine.module.config.attention_backend})")
        return engine

    def _inference_view(self):
        """The inference engine, built on first use and refreshed when
        training moved the parameters since the last sync."""
        if self._infer_engine is None:
            self._infer_engine = self._build_inference_engine()
            self._infer_params_stale = False
        elif self._infer_params_stale:
            self._refresh_inference_params()
        return self._infer_engine

    def _refresh_inference_params(self, digest: bool = True) -> dict:
        """Copy the live parameters into the view (``runtime/rlhf/sync``),
        digest the result if ``digest`` and not ``DS_RLHF_SYNC_DIGEST=0``,
        and return the sync's evidence row (also kept in
        ``weight_sync_log``)."""
        from deepspeed_tpu_torch.runtime.rlhf.sync import execute_params_sync, plan_params_sync

        t0 = time.perf_counter()
        values = self._inference_params_value()
        template = self._infer_engine.module.state_dict()
        plan = plan_params_sync(values, template)
        digest = digest and os.environ.get("DS_RLHF_SYNC_DIGEST", "1") != "0"
        _, evidence = execute_params_sync(values, template, plan_summary=plan, digest=digest)
        self._infer_params_stale = False
        self.weight_sync_generation += 1
        evidence["generation"] = self.weight_sync_generation
        self.last_weight_sync = evidence
        self.weight_sync_log.append(evidence)
        self._gather_latency += time.perf_counter() - t0
        return evidence

    # ------------------------------------------------------------------
    def generate(self, input_ids, **kwargs) -> torch.Tensor:
        """Serve from the current training weights (the inference
        engine's ``generate`` and its arguments)."""
        t0 = time.perf_counter()
        out = self._inference_view().generate(input_ids, **kwargs)
        self._generate_latency += time.perf_counter() - t0
        return out

    def infer_forward(self, input_ids) -> torch.Tensor:
        """Logits from the inference view (no cache)."""
        return self._inference_view().forward(input_ids)

    # -- in-flight rollouts on the continuous scheduler ------------------
    def rollout_scheduler(self, serving_config=None, telemetry=None, seed: int = 0):
        """A :class:`ContinuousBatchingScheduler` over the inference view,
        for in-flight RLHF rollouts. It serves the live training weights as
        of its construction; :meth:`sync_rollout_weights` hot-swaps them
        between ticks."""
        from deepspeed_tpu_torch.inference.serving import ContinuousBatchingScheduler

        sched = ContinuousBatchingScheduler(self._inference_view(), serving_config,
                                            telemetry=telemetry, seed=seed)
        sched.weight_sync_generation = self.weight_sync_generation
        return sched

    def sync_rollout_weights(self, scheduler) -> dict:
        """Refresh the view from the live parameters, then hot-swap the
        scheduler's served weights between ticks: digest-verified on fp
        weights, re-encoded under the scheduler's int8/int4 view. The view
        is digested only where the scheduler checks it (fp): a re-encode is
        lossy, and JAX's digest of the view there is never read. Returns
        the sync's evidence row."""
        if self._infer_engine is None:
            raise RuntimeError("rollout_scheduler() must run before sync_rollout_weights()")
        fp = scheduler.weight_dtype == "fp"
        evidence = self._refresh_inference_params(digest=fp)
        expected = evidence.get("digest") if fp else None
        scheduler.swap_served_params(self._infer_engine.params, expected_digest=expected,
                                     generation=self.weight_sync_generation, evidence=evidence)
        return evidence

    # -- LoRA (reference :141-160) ----------------------------------------
    def fuse_lora_weight(self) -> None:
        self.is_lora_fused = True
        self._infer_params_stale = True

    def unfuse_lora_weight(self) -> None:
        self.is_lora_fused = False
        self._infer_params_stale = True

    unfuse_lora_weight_non_pinned = unfuse_lora_weight

    def release_inference_cache(self) -> None:
        """The reference frees its inference KV workspace (:161). The port
        allocates the decode cache per ``generate`` call and frees it at the
        call's end; this returns those freed blocks to the driver."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def hybrid_stats(self) -> Dict[str, float]:
        """(the reference prints these in ``generate`` every N iterations)"""
        return {"generate_latency_s": self._generate_latency,
                "training_latency_s": self._training_latency,
                "gather_latency_s": self._gather_latency,
                "iters": self._iters}
