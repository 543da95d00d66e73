"""Elastic training: batch configuration that holds at every card count
(the port's copy of ``deepspeed_tpu/elasticity/elasticity.py``; reference
``deepspeed/elasticity/elasticity.py``: v0.1 ``:83``, v0.2 ``:126``,
``compute_elastic_config`` ``:233``).

The same algorithm and names ("gpus" are cards; v0.2's node granularity is
cards per host). ``DeepSpeedConfig`` applies the plan to the batch triangle
when the ``"elasticity"`` block is enabled (``runtime/config.py``), and
``DSElasticAgent.validate_world_sizes`` checks a restart ladder against it.
It imports nothing above the standard library, so that a supervisor can use
it without touching the device.
"""

import math
from functools import reduce
from typing import Dict, List

LATEST_ELASTICITY_VERSION = 0.2
MINIMUM_DEEPSPEED_VERSION = "0.3.8"
ENABLED = "enabled"
ENABLED_DEFAULT = False


class ElasticityError(Exception):
    """Base (reference ``elasticity/constants.py`` error family)."""


class ElasticityConfigError(ElasticityError):
    pass


class ElasticityIncompatibleWorldSize(ElasticityError):
    pass


class ElasticityConfig:
    """Reference ``elasticity/config.py``: typed view of the elasticity
    config block."""

    def __init__(self, param_dict: Dict):
        self.enabled = param_dict.get(ENABLED, ENABLED_DEFAULT)
        if self.enabled:
            if "max_train_batch_size" not in param_dict:
                raise ElasticityConfigError("Max train batch size is needed for elasticity")
            if "micro_batch_sizes" not in param_dict:
                raise ElasticityConfigError("Micro batch sizes are needed for elasticity")
        self.max_acceptable_batch_size = param_dict.get("max_train_batch_size", 0)
        self.micro_batches = param_dict.get("micro_batch_sizes", [])
        if not isinstance(self.micro_batches, list) or not all(
                isinstance(m, int) and m > 0 for m in self.micro_batches):
            raise ElasticityConfigError(f"micro_batch_sizes must be positive ints, got "
                                        f"{self.micro_batches}")
        self.min_gpus = param_dict.get("min_gpus", 1)
        self.max_gpus = param_dict.get("max_gpus", -1)
        if self.min_gpus < 1 or (self.max_gpus != -1 and self.max_gpus < self.min_gpus):
            raise ElasticityConfigError(f"invalid min/max cards: {self.min_gpus}/{self.max_gpus}")
        self.min_time = param_dict.get("min_time", 0)
        self.version = param_dict.get("version", LATEST_ELASTICITY_VERSION)
        self.prefer_larger_batch_size = param_dict.get("prefer_larger_batch", True)
        self.ignore_non_elastic_batch_info = param_dict.get("ignore_non_elastic_batch_info", False)
        self.num_gpus_per_node = param_dict.get("num_gpus_per_node", 1)
        self.model_parallel_size = param_dict.get("model_parallel_size", 1)


def get_candidate_batch_sizes(base_list: List[int], max_acceptable_batch_size: int) -> List[int]:
    """Reference ``:27``: the largest multiple of each base <= max."""
    candidates = set()
    for base in base_list:
        if base <= max_acceptable_batch_size:
            candidates.add((max_acceptable_batch_size // base) * base)
    return sorted(candidates)


def get_valid_gpus(batch_size: int, micro_batches: List[int], min_valid_gpus: int,
                   max_valid_gpus: int) -> List[int]:
    """Reference ``:41``: the card counts n such that some micro-batch
    divides batch_size/n evenly."""
    valid = []
    for n in range(min_valid_gpus, max_valid_gpus + 1):
        if batch_size % n != 0:
            continue
        per = batch_size // n
        if any(per % mb == 0 for mb in micro_batches):
            valid.append(n)
    return valid


def get_best_candidates(candidate_batch_sizes, micro_batches, min_gpus, max_gpus, prefer_larger):
    """Reference ``:63``: the most compatible card counts win; ties prefer
    the larger (or smaller) batch."""
    max_valid_gpus = 0
    valid_gpus = None
    final_batch_size = int(min(micro_batches))
    for batch_size in candidate_batch_sizes:
        current = get_valid_gpus(batch_size, micro_batches, min_gpus, max_gpus)
        if len(current) > max_valid_gpus or (len(current) == max_valid_gpus and
                                             ((prefer_larger and batch_size > final_batch_size) or
                                              (not prefer_larger and batch_size < final_batch_size))):
            max_valid_gpus = len(current)
            valid_gpus = current
            final_batch_size = batch_size
    return final_batch_size, valid_gpus


def _get_compatible_gpus_v01(micro_batches, max_acceptable_batch_size, min_gpus=None, max_gpus=None,
                             prefer_larger=True):
    """Reference ``:83``: LCM + per-micro-batch bases, brute-force count."""
    min_gpus = min_gpus or 1
    max_gpus = max_gpus or max_acceptable_batch_size // min(micro_batches)
    if not all(mb <= max_acceptable_batch_size for mb in micro_batches):
        raise ValueError("All micro batches must be <= max_acceptable_batch_size")
    lcm = reduce(math.lcm, micro_batches)
    base_list = list(micro_batches) + [lcm]
    candidates = get_candidate_batch_sizes(base_list, max_acceptable_batch_size)
    return get_best_candidates(candidates, micro_batches, min_gpus, max_gpus, prefer_larger)


def _get_compatible_gpus_v02(micro_batches, max_acceptable_batch_size, current_num_gpus,
                             min_gpus=None, max_gpus=None, prefer_larger=True, num_gpus_per_node=1,
                             model_parallel_size=1):
    """Reference ``:126``: host-granular world sizes under model parallelism."""
    if num_gpus_per_node % model_parallel_size != 0:
        raise ElasticityError(f"cards per host {num_gpus_per_node} must be divisible by model "
                              f"parallel size {model_parallel_size}")
    dp_size_per_node = num_gpus_per_node // model_parallel_size
    final_batch_size, valid_world_size = _get_compatible_gpus_v01(
        micro_batches, int(max_acceptable_batch_size / dp_size_per_node),
        (min_gpus or 1) // num_gpus_per_node or 1,
        (max_gpus or max_acceptable_batch_size // min(micro_batches)) // num_gpus_per_node,
        prefer_larger)
    final_batch_size = int(final_batch_size) * dp_size_per_node
    valid_dp_world_sizes = [i * dp_size_per_node for i in valid_world_size]
    valid_world_sizes = [i * model_parallel_size for i in valid_dp_world_sizes]
    if current_num_gpus // model_parallel_size in valid_dp_world_sizes:
        micro = None
        for mb in micro_batches:
            if final_batch_size // (current_num_gpus // model_parallel_size) % mb == 0:
                if micro is None or (prefer_larger and mb > micro):
                    micro = mb
        return final_batch_size, valid_world_sizes, micro
    raise ElasticityIncompatibleWorldSize(
        f"world size {current_num_gpus} with MP {model_parallel_size} is not in the valid set "
        f"{valid_world_sizes}")


def elasticity_enabled(ds_config: dict) -> bool:
    return ds_config.get("elasticity", {}).get(ENABLED, ENABLED_DEFAULT)


def compute_elastic_config(ds_config: dict, target_deepspeed_version: str = "", world_size: int = 0,
                           return_microbatch: bool = False):
    """Reference ``:233``: resolve the elastic batch plan; validates the
    current world size when given."""
    elastic_config_dict = ds_config.get("elasticity", {})
    elastic_config = ElasticityConfig(elastic_config_dict)
    if not elastic_config.enabled:
        raise ElasticityConfigError("elasticity is not enabled in the config")

    if float(elastic_config.version) == 0.1:
        final_batch_size, valid_gpus = _get_compatible_gpus_v01(
            micro_batches=elastic_config.micro_batches,
            max_acceptable_batch_size=elastic_config.max_acceptable_batch_size,
            min_gpus=elastic_config.min_gpus,
            max_gpus=None if elastic_config.max_gpus == -1 else elastic_config.max_gpus,
            prefer_larger=elastic_config.prefer_larger_batch_size)
        micro_batch = None
        if world_size > 0:
            if world_size not in valid_gpus:
                raise ElasticityIncompatibleWorldSize(f"world size {world_size} not in valid set "
                                                      f"{valid_gpus}")
            if return_microbatch:
                per = final_batch_size // world_size
                cands = [mb for mb in elastic_config.micro_batches if per % mb == 0]
                micro_batch = max(cands) if elastic_config.prefer_larger_batch_size else min(cands)
        if return_microbatch:
            return final_batch_size, valid_gpus, micro_batch
        return final_batch_size, valid_gpus
    if float(elastic_config.version) == 0.2:
        final_batch_size, valid_gpus, micro_batch = _get_compatible_gpus_v02(
            micro_batches=elastic_config.micro_batches,
            max_acceptable_batch_size=elastic_config.max_acceptable_batch_size,
            current_num_gpus=world_size or elastic_config.num_gpus_per_node,
            min_gpus=elastic_config.min_gpus,
            max_gpus=None if elastic_config.max_gpus == -1 else elastic_config.max_gpus,
            prefer_larger=elastic_config.prefer_larger_batch_size,
            num_gpus_per_node=elastic_config.num_gpus_per_node,
            model_parallel_size=elastic_config.model_parallel_size)
        if return_microbatch:
            return final_batch_size, valid_gpus, micro_batch
        return final_batch_size, valid_gpus
    raise ElasticityConfigError(f"unknown elasticity version {elastic_config.version}")
