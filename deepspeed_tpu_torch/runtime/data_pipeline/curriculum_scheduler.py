"""Curriculum-learning difficulty scheduler (counterpart of
``deepspeed_tpu/runtime/data_pipeline/curriculum_scheduler.py``): the same
four schedule types and config keys, host-side Python (the difficulty is the
sequence length the engine truncates a batch to)."""

import math
from typing import Callable, Dict, Optional

from deepspeed_tpu_torch.runtime.data_pipeline import constants as K


class CurriculumScheduler:
    """Maps ``global_steps -> difficulty`` (reference semantics:
    ``fixed_discrete`` step table, ``fixed_linear``/``fixed_root`` ramps,
    ``custom`` user callback)."""

    def __init__(self, config: Dict):
        self.state: Dict = {}
        for key in (K.CURRICULUM_LEARNING_MIN_DIFFICULTY,
                    K.CURRICULUM_LEARNING_MAX_DIFFICULTY,
                    K.CURRICULUM_LEARNING_SCHEDULE_TYPE):
            assert key in config, f"Curriculum learning requires the config '{key}'"
        self.state[K.CURRICULUM_LEARNING_MIN_DIFFICULTY] = config[K.CURRICULUM_LEARNING_MIN_DIFFICULTY]
        self.state[K.CURRICULUM_LEARNING_MAX_DIFFICULTY] = config[K.CURRICULUM_LEARNING_MAX_DIFFICULTY]
        self.state[K.CURRICULUM_LEARNING_CURRENT_DIFFICULTY] = config[K.CURRICULUM_LEARNING_MIN_DIFFICULTY]
        self.state[K.CURRICULUM_LEARNING_SCHEDULE_TYPE] = config[K.CURRICULUM_LEARNING_SCHEDULE_TYPE]
        self.custom_get_difficulty: Optional[Callable[[int], int]] = None

        stype = config[K.CURRICULUM_LEARNING_SCHEDULE_TYPE]
        sconf = config.get(K.CURRICULUM_LEARNING_SCHEDULE_CONFIG, {})
        if stype == K.CURRICULUM_LEARNING_SCHEDULE_FIXED_DISCRETE:
            diffs = sconf.get(K.CURRICULUM_LEARNING_SCHEDULE_DIFFICULTY)
            steps = sconf.get(K.CURRICULUM_LEARNING_SCHEDULE_MAX_STEP)
            assert diffs and steps is not None, \
                "fixed_discrete needs schedule_config.difficulty and .max_step"
            assert len(diffs) == len(steps) + 1, \
                "difficulty must have one more entry than max_step (last difficulty is terminal)"
            self.state[K.CURRICULUM_LEARNING_SCHEDULE_CONFIG] = sconf
        elif stype in (K.CURRICULUM_LEARNING_SCHEDULE_FIXED_ROOT,
                       K.CURRICULUM_LEARNING_SCHEDULE_FIXED_LINEAR):
            assert K.CURRICULUM_LEARNING_SCHEDULE_TOTAL_STEP in sconf, \
                f"{stype} needs schedule_config.{K.CURRICULUM_LEARNING_SCHEDULE_TOTAL_STEP}"
            assert K.CURRICULUM_LEARNING_SCHEDULE_DIFFICULTY_STEP in sconf, \
                f"{stype} needs schedule_config.{K.CURRICULUM_LEARNING_SCHEDULE_DIFFICULTY_STEP}"
            if stype == K.CURRICULUM_LEARNING_SCHEDULE_FIXED_ROOT:
                assert K.CURRICULUM_LEARNING_SCHEDULE_ROOT_DEGREE in sconf, \
                    "fixed_root needs schedule_config.root_degree"
            self.state[K.CURRICULUM_LEARNING_SCHEDULE_CONFIG] = sconf
        elif stype == K.CURRICULUM_LEARNING_SCHEDULE_CUSTOM:
            pass
        else:
            raise RuntimeError(f"Unsupported curriculum schedule type {stype!r}")

    # -- reference API surface (curriculum_scheduler.py:107-158) ----------
    def get_current_difficulty(self) -> int:
        return self.state[K.CURRICULUM_LEARNING_CURRENT_DIFFICULTY]

    def set_current_difficulty(self, difficulty: int) -> None:
        self.state[K.CURRICULUM_LEARNING_CURRENT_DIFFICULTY] = difficulty

    def set_custom_get_difficulty(self, schedule_function: Callable[[int], int]) -> None:
        self.custom_get_difficulty = schedule_function

    def get_state(self) -> Dict:
        return self.state

    def set_state(self, state: Dict) -> None:
        self.state = state

    def _fixed_discrete(self, global_steps: int) -> int:
        sconf = self.state[K.CURRICULUM_LEARNING_SCHEDULE_CONFIG]
        max_steps = sconf[K.CURRICULUM_LEARNING_SCHEDULE_MAX_STEP]
        diffs = sconf[K.CURRICULUM_LEARNING_SCHEDULE_DIFFICULTY]
        for i, cap in enumerate(max_steps):
            if global_steps <= cap:
                return diffs[i]
        return diffs[-1]

    def _fixed_root(self, global_steps: int, root_degree: Optional[int] = None) -> int:
        sconf = self.state[K.CURRICULUM_LEARNING_SCHEDULE_CONFIG]
        if root_degree is None:
            root_degree = sconf[K.CURRICULUM_LEARNING_SCHEDULE_ROOT_DEGREE]
        lo = self.state[K.CURRICULUM_LEARNING_MIN_DIFFICULTY]
        hi = self.state[K.CURRICULUM_LEARNING_MAX_DIFFICULTY]
        frac = (float(global_steps) / sconf[K.CURRICULUM_LEARNING_SCHEDULE_TOTAL_STEP]) ** (1.0 / root_degree)
        nxt = math.floor(frac * (hi - lo) + lo)
        nxt -= nxt % sconf[K.CURRICULUM_LEARNING_SCHEDULE_DIFFICULTY_STEP]
        return min(nxt, hi)

    def get_difficulty(self, global_steps: int) -> int:
        stype = self.state[K.CURRICULUM_LEARNING_SCHEDULE_TYPE]
        if stype == K.CURRICULUM_LEARNING_SCHEDULE_FIXED_DISCRETE:
            return self._fixed_discrete(global_steps)
        if stype == K.CURRICULUM_LEARNING_SCHEDULE_FIXED_LINEAR:
            return self._fixed_root(global_steps, 1)
        if stype == K.CURRICULUM_LEARNING_SCHEDULE_FIXED_ROOT:
            return self._fixed_root(global_steps)
        assert self.custom_get_difficulty is not None, \
            "custom schedule requires set_custom_get_difficulty()"
        return self.custom_get_difficulty(global_steps)

    def update_difficulty(self, global_steps: int) -> int:
        if (self.state[K.CURRICULUM_LEARNING_CURRENT_DIFFICULTY]
                < self.state[K.CURRICULUM_LEARNING_MAX_DIFFICULTY]):
            self.state[K.CURRICULUM_LEARNING_CURRENT_DIFFICULTY] = self.get_difficulty(global_steps)
        return self.state[K.CURRICULUM_LEARNING_CURRENT_DIFFICULTY]
