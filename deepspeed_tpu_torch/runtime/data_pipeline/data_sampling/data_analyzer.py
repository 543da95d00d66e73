"""Offline data analysis — difficulty-map construction for curriculum
learning (reference ``data_sampling/data_analyzer.py:417`` ``DataAnalyzer``
``run_map``/``run_reduce``: workers scan dataset shards computing per-sample
metric values, then a reduce pass merges shard outputs into the
``index_to_metric`` / ``index_to_sample_percentile_merged`` files the
``DeepSpeedDataSampler`` mmaps at train time).

The analysis is host-side numpy (no device involvement), as in
``deepspeed_tpu/runtime/data_pipeline/data_sampling/data_analyzer.py``;
sharding is by ``worker_id``/``num_workers`` exactly like the reference so
big corpora can be scanned in parallel processes; outputs are the repo's
``MMapIndexedDataset`` format, which the sampler's ``index_to_metric_path``
consumes directly.
"""

import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from deepspeed_tpu_torch.runtime.data_pipeline.data_sampling.indexed_dataset import (
    MMapIndexedDataset, MMapIndexedDatasetBuilder)


class DataAnalyzer:
    """Map-reduce over a dataset producing per-metric difficulty files.

    ``metric_functions[name](sample) -> int`` (a scalar difficulty, e.g.
    sequence length or vocab rarity). ``metric_types[name]`` is
    ``"single_value_per_sample"`` (the only type the sampler consumes;
    ``"accumulate_value"`` totals a corpus statistic, reference
    ``data_analyzer.py`` same split).
    """

    def __init__(self,
                 dataset: Sequence,
                 metric_names: List[str],
                 metric_functions: Dict[str, Callable],
                 save_path: str,
                 metric_types: Optional[Dict[str, str]] = None,
                 num_workers: int = 1,
                 worker_id: int = 0):
        assert set(metric_names) == set(metric_functions), \
            "metric_names and metric_functions must agree"
        self.dataset = dataset
        self.metric_names = list(metric_names)
        self.metric_functions = metric_functions
        self.metric_types = metric_types or {n: "single_value_per_sample"
                                             for n in metric_names}
        self.save_path = save_path
        self.num_workers = num_workers
        self.worker_id = worker_id
        if not (0 <= worker_id < num_workers):
            raise ValueError(f"worker_id {worker_id} out of range for {num_workers} workers")

    # -- paths -----------------------------------------------------------
    def _metric_dir(self, name: str) -> str:
        return os.path.join(self.save_path, name)

    def _shard_prefix(self, name: str, worker: int) -> str:
        return os.path.join(self._metric_dir(name), f"worker{worker}_index_to_metric")

    def metric_path(self, name: str) -> str:
        """The merged per-sample metric file the sampler consumes as
        ``index_to_metric_path``."""
        return os.path.join(self._metric_dir(name), "index_to_metric")

    def sample_path(self, name: str) -> str:
        """metric-sorted sample ids (``index_to_sample``): row i holds the
        sample indices whose metric equals the i-th distinct value."""
        return os.path.join(self._metric_dir(name), "index_to_sample")

    # -- map: this worker's shard ---------------------------------------
    def run_map(self) -> None:
        n = len(self.dataset)
        lo = (n * self.worker_id) // self.num_workers
        hi = (n * (self.worker_id + 1)) // self.num_workers
        builders = {}
        accum: Dict[str, int] = {}
        for name in self.metric_names:
            os.makedirs(self._metric_dir(name), exist_ok=True)
            if self.metric_types[name] == "single_value_per_sample":
                builders[name] = MMapIndexedDatasetBuilder(
                    self._shard_prefix(name, self.worker_id), dtype=np.int64)
            else:
                accum[name] = 0
        for i in range(lo, hi):
            sample = self.dataset[i]
            for name in self.metric_names:
                v = int(self.metric_functions[name](sample))
                if name in builders:
                    builders[name].add_item([v])
                else:
                    accum[name] += v
        for b in builders.values():
            b.finalize()
        for name, total in accum.items():
            np.save(os.path.join(self._metric_dir(name),
                                 f"worker{self.worker_id}_accumulate.npy"), total)

    # -- reduce: merge every worker's shard ------------------------------
    def run_reduce(self) -> None:
        for name in self.metric_names:
            if self.metric_types[name] != "single_value_per_sample":
                totals = [np.load(os.path.join(self._metric_dir(name),
                                               f"worker{w}_accumulate.npy"))
                          for w in range(self.num_workers)]
                np.save(os.path.join(self._metric_dir(name), "accumulate.npy"),
                        int(np.sum(totals)))
                continue
            merged = MMapIndexedDatasetBuilder(self.metric_path(name), dtype=np.int64)
            for w in range(self.num_workers):
                merged.merge_file_(self._shard_prefix(name, w))
            merged.finalize()
            # metric→samples view (reference index_to_sample files): one row
            # of sample ids per distinct metric value, ascending
            ds = MMapIndexedDataset(self.metric_path(name))
            values = np.asarray([int(ds[i][0]) for i in range(len(ds))])
            order = np.argsort(values, kind="stable")
            s_builder = MMapIndexedDatasetBuilder(self.sample_path(name), dtype=np.int64)
            # single O(N log N) pass: order is metric-sorted, so rows are
            # contiguous slices split at the value-change boundaries
            uniq, counts = np.unique(values, return_counts=True)
            if len(values):  # np.split on empty yields one phantom row
                for ids in np.split(order, np.cumsum(counts)[:-1]):
                    s_builder.add_item(ids.tolist())
            s_builder.finalize()
            np.save(os.path.join(self._metric_dir(name), "metric_values.npy"),
                    uniq.astype(np.int64))

    def run_map_reduce(self) -> None:
        """Single-process convenience: every shard then the merge
        (reference ``run_map_reduce``)."""
        saved_worker = self.worker_id
        try:
            for w in range(self.num_workers):
                self.worker_id = w
                self.run_map()
        finally:
            self.worker_id = saved_worker
        self.run_reduce()
