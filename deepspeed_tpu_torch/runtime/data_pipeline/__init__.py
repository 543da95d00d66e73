"""Data-efficiency pipeline (counterpart of
``deepspeed_tpu/runtime/data_pipeline``): curriculum learning,
curriculum-aware sampling, mmap indexed datasets, and random-LTD token
dropping."""

from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import CurriculumScheduler
from deepspeed_tpu_torch.runtime.data_pipeline.data_routing.basic_layer import RandomLayerTokenDrop
from deepspeed_tpu_torch.runtime.data_pipeline.data_routing.scheduler import RandomLTDScheduler
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling.data_sampler import DeepSpeedDataSampler
from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling.indexed_dataset import (
    MMapIndexedDataset, MMapIndexedDatasetBuilder)

__all__ = ["CurriculumScheduler", "DeepSpeedDataSampler", "MMapIndexedDataset",
           "MMapIndexedDatasetBuilder", "RandomLTDScheduler", "RandomLayerTokenDrop"]
