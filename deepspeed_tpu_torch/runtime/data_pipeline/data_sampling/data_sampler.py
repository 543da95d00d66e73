"""Curriculum-aware distributed data sampler (reference
``data_pipeline/data_sampling/data_sampler.py:338`` ``DeepSpeedDataSampler``).

Behavioural parity: per-metric curriculum schedulers gate which samples are
eligible each global batch (value- or percentile-based difficulty), batches
are drawn deterministically from a seeded RNG, every DP rank sees its own
micro-batch slice, and ``state_dict``/``load_state_dict`` resume the
sequence exactly. The reference's on-disk cluster shuffling
(``get_new_cluster``/``sample_from_clusters``) collapses to in-memory
boolean masks over the metric arrays — the same sets of samples, without
the torch/file machinery. The port's copy of
``deepspeed_tpu/runtime/data_pipeline/data_sampling/data_sampler.py``: the
same seeded ``numpy`` generator, so each rank gets JAX's index sequence.
"""

import logging
from typing import Dict, Iterator, List, Optional

import numpy as np

from deepspeed_tpu_torch.runtime.data_pipeline import constants as K
from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler

logger = logging.getLogger(__name__)


class DeepSpeedDataSampler:

    def __init__(self,
                 data_efficiency_config: Dict,
                 one_epoch_total_samples: int,
                 micro_batch_size: int,
                 data_parallel_rank: int,
                 data_parallel_size: int,
                 gradient_accumulation_steps: int,
                 global_rank: int = 0,
                 drop_last: bool = True,
                 metric_values: Optional[Dict[str, np.ndarray]] = None):
        self.data_efficiency_config = data_efficiency_config
        self.one_epoch_total_samples = one_epoch_total_samples
        sampling = data_efficiency_config.get(K.DATA_SAMPLING, {})
        self.total_samples = one_epoch_total_samples * int(
            sampling.get("num_epochs", K.DATA_SAMPLING_NUM_EPOCHS_DEFAULT))
        self.micro_batch_size = micro_batch_size
        self.data_parallel_rank = data_parallel_rank
        self.data_parallel_size = data_parallel_size
        self.micro_batch_times_data_parallel_size = micro_batch_size * data_parallel_size
        self.gradient_accumulation_steps = gradient_accumulation_steps
        self.global_batch_size = (self.micro_batch_times_data_parallel_size
                                  * gradient_accumulation_steps)
        self.global_rank = global_rank
        self.drop_last = drop_last
        seed = int(data_efficiency_config.get("seed", K.DATA_EFFICIENCY_SEED_DEFAULT))
        self.np_rng = np.random.default_rng(seed)
        self.consumed_samples = 0
        self.curriculum_step = 0

        cl_cfg = sampling.get(K.CURRICULUM_LEARNING, {})
        self.curriculum_enabled = bool(cl_cfg.get("enabled", False))
        self.curriculum_schedulers: Dict[str, CurriculumScheduler] = {}
        self.difficulty_type: Dict[str, str] = {}
        self.current_difficulties: Dict[str, int] = {}
        self._metric_values: Dict[str, np.ndarray] = {}
        self._metric_ranks: Dict[str, np.ndarray] = {}
        if self.curriculum_enabled:
            metrics = cl_cfg.get(K.CURRICULUM_LEARNING_METRICS, {})
            assert metrics, "curriculum_learning enabled but no curriculum_metrics given"
            for name, mcfg in metrics.items():
                self.curriculum_schedulers[name] = CurriculumScheduler(mcfg)
                self.difficulty_type[name] = mcfg.get(K.CURRICULUM_LEARNING_DIFFICULTY_TYPE,
                                                      K.CURRICULUM_LEARNING_VALUE_BASED)
                values = None
                if metric_values and name in metric_values:
                    values = np.asarray(metric_values[name])
                elif "index_to_metric_path" in mcfg:
                    from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling.indexed_dataset import \
                        MMapIndexedDataset
                    ds = MMapIndexedDataset(mcfg["index_to_metric_path"])
                    values = np.asarray([int(ds[i][0]) for i in range(len(ds))])
                assert values is not None, \
                    f"metric {name!r}: pass metric_values= or index_to_metric_path"
                assert len(values) == one_epoch_total_samples, \
                    f"metric {name!r} has {len(values)} values for {one_epoch_total_samples} samples"
                self._metric_values[name] = values
                if self.difficulty_type[name] == K.CURRICULUM_LEARNING_PERCENTILE_BASED:
                    # rank -> percentile in [0, 100]
                    order = np.argsort(values, kind="stable")
                    ranks = np.empty_like(order)
                    ranks[order] = np.arange(len(values))
                    self._metric_ranks[name] = (ranks + 1) * 100.0 / len(values)

    def __len__(self) -> int:
        return self.total_samples

    def set_custom_curriculum_learning_schedule(self, schedule_func_dict: Dict) -> None:
        """(reference data_sampler.py:117)"""
        for name, fn in schedule_func_dict.items():
            assert name in self.curriculum_schedulers, f"unknown curriculum metric {name!r}"
            self.curriculum_schedulers[name].set_custom_get_difficulty(fn)

    # ------------------------------------------------------------------
    def _eligible_mask(self) -> np.ndarray:
        mask = np.ones(self.one_epoch_total_samples, dtype=bool)
        for name, sched in self.curriculum_schedulers.items():
            diff = self.current_difficulties[name]
            if self.difficulty_type[name] == K.CURRICULUM_LEARNING_VALUE_BASED:
                mask &= self._metric_values[name] <= diff
            else:
                mask &= self._metric_ranks[name] <= diff
        return mask

    def get_next_global_batch(self) -> np.ndarray:
        """(reference ``get_next_global_batch`` data_sampler.py:258)"""
        if self.curriculum_enabled:
            self.curriculum_step += 1
            for name, sched in self.curriculum_schedulers.items():
                self.current_difficulties[name] = sched.update_difficulty(self.curriculum_step)
            pool = np.flatnonzero(self._eligible_mask())
            if len(pool) < self.global_batch_size:
                logger.warning(f"curriculum pool ({len(pool)}) smaller than global batch "
                               f"({self.global_batch_size}); sampling with replacement")
                return self.np_rng.choice(pool, size=self.global_batch_size, replace=True)
            return self.np_rng.choice(pool, size=self.global_batch_size, replace=False)
        start = self.consumed_samples % self.one_epoch_total_samples
        idx = (start + np.arange(self.global_batch_size)) % self.one_epoch_total_samples
        return idx

    def get_start_end_idx(self) -> tuple:
        """This DP rank's slice of a global micro-batch row
        (reference data_sampler.py:122)."""
        start = self.data_parallel_rank * self.micro_batch_size
        return start, start + self.micro_batch_size

    def __iter__(self) -> Iterator[List[int]]:
        while self.consumed_samples <= self.total_samples - self.global_batch_size:
            batch = self.get_next_global_batch()
            self.consumed_samples += self.global_batch_size
            # yield one micro-batch per GAS tick, sliced for this rank
            for g in range(self.gradient_accumulation_steps):
                row = batch[g * self.micro_batch_times_data_parallel_size:
                            (g + 1) * self.micro_batch_times_data_parallel_size]
                s, e = self.get_start_end_idx()
                yield row[s:e].tolist()

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        """(reference data_sampler.py:305)"""
        return {
            K.CURRICULUM_LEARNING_STEP: self.curriculum_step,
            K.CURRICULUM_LEARNING_CONSUMED_SAMPLES: self.consumed_samples,
            K.CURRICULUM_LEARNING_CURRENT_DIFFICULTIES: dict(self.current_difficulties),
            K.CURRICULUM_LEARNING_NP_RNG_STATE: self.np_rng.bit_generator.state,
        }

    def load_state_dict(self, state_dict: Dict) -> None:
        """(reference data_sampler.py:316)"""
        self.curriculum_step = state_dict[K.CURRICULUM_LEARNING_STEP]
        self.consumed_samples = state_dict[K.CURRICULUM_LEARNING_CONSUMED_SAMPLES]
        self.current_difficulties = dict(state_dict[K.CURRICULUM_LEARNING_CURRENT_DIFFICULTIES])
        self.np_rng.bit_generator.state = state_dict[K.CURRICULUM_LEARNING_NP_RNG_STATE]
        for name, diff in self.current_difficulties.items():
            if name in self.curriculum_schedulers:
                self.curriculum_schedulers[name].set_current_difficulty(diff)
