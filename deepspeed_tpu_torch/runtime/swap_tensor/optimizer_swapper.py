"""NVMe optimizer-state swapping (ZeRO-Infinity), counterpart of
``deepspeed_tpu/runtime/swap_tensor/optimizer_swapper.py``.

The Adam moments live on disk as one file pair per leaf
(``exp_avg_<i>.bin``, ``exp_avg_sq_<i>.bin``, JAX's names). A step streams
them through host RAM double-buffered: while leaf ``i`` is updated by the
C++ Adam kernel, leaf ``i+1``'s moments are being read by the aio thread
pool and leaf ``i-1``'s written back.
"""

import ctypes
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam, HostArray, host_view
from deepspeed_tpu_torch.ops.aio.aio_handle import AsyncIOHandle, check_io


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class PipelinedOptimizerSwapper:
    """The moment files of one swap dir and the two aio handles that read
    and write them (O_DIRECT by default: swap traffic must not churn the
    page cache)."""

    def __init__(self, swap_dir: str, n_threads: int = 4, use_direct: bool = True):
        self.swap_dir = Path(swap_dir)
        self.swap_dir.mkdir(parents=True, exist_ok=True)
        self.read_handle = AsyncIOHandle(n_threads, use_direct=use_direct)
        self.write_handle = AsyncIOHandle(n_threads, use_direct=use_direct)
        self._sizes: Dict[int, int] = {}

    def _paths(self, idx: int):
        return (self.swap_dir / f"exp_avg_{idx}.bin", self.swap_dir / f"exp_avg_sq_{idx}.bin")

    def initialize(self, sizes: List[int], reuse_existing: bool = False) -> None:
        """Write zeroed moment files. ``reuse_existing`` keeps files of the
        right size already on disk: only for a resume, never a fresh run
        (a shared swap dir must not hand another run's moments on)."""
        for i, n in enumerate(sizes):
            self._sizes[i] = n
            mp, vp = self._paths(i)
            stale = mp.exists() and mp.stat().st_size != n * 4
            if not reuse_existing or not mp.exists() or stale:
                zeros = np.zeros(n, np.float32)
                self.write_handle.pwrite(zeros, mp)
                self.write_handle.pwrite(zeros, vp)
        errs = self.write_handle.wait()
        check_io(errs, f"swap-file writes in {self.swap_dir}")

    def swap_in_async(self, idx: int, m_buf: np.ndarray, v_buf: np.ndarray) -> None:
        mp, vp = self._paths(idx)
        self.read_handle.pread(m_buf, mp)
        self.read_handle.pread(v_buf, vp)

    def wait_swap_in(self) -> None:
        errs = self.read_handle.wait()
        check_io(errs, "optimizer state swap-in")

    def swap_out_async(self, idx: int, m: np.ndarray, v: np.ndarray) -> None:
        mp, vp = self._paths(idx)
        self.write_handle.pwrite(m.copy(), mp)
        self.write_handle.pwrite(v.copy(), vp)

    def wait_swap_out(self) -> None:
        errs = self.write_handle.wait()
        check_io(errs, "optimizer state swap-out")

    def direct_fallbacks(self) -> int:
        return self.read_handle.direct_fallbacks() + self.write_handle.direct_fallbacks()

    def close(self) -> None:
        self.read_handle.close()
        self.write_handle.close()


class NVMeAdam:
    """Adam whose moments live on NVMe: the C++ update over pipelined,
    double-buffered aio swapping (JAX ``NVMeAdam``)."""

    def __init__(self, swap_dir: str, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 adamw_mode=True, n_threads: int = 4):
        self.inner = DeepSpeedCPUAdam(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      adamw_mode=adamw_mode)
        self.swapper = PipelinedOptimizerSwapper(swap_dir, n_threads)
        self._initialized = False
        self._resumed = False
        # two host buffer pairs (the moments of the leaf being updated and
        # of the next one)
        self._bufs: List[Optional[np.ndarray]] = [None, None, None, None]

    def _ensure_buffers(self, max_size: int) -> None:
        if self._bufs[0] is None or self._bufs[0].size < max_size:
            self._bufs = [np.empty(max_size, np.float32) for _ in range(4)]

    def step(self, params: List[HostArray], grads: List[HostArray], lr: Optional[float] = None):
        params = [host_view(p, "the master") for p in params]
        n_leaves = len(params)
        sizes = [p.size for p in params]
        if not self._initialized:
            self.swapper.initialize(sizes, reuse_existing=self._resumed)
            self._initialized = True
        self._ensure_buffers(max(sizes))
        self.inner.step_count += 1
        use_lr = self.inner.lr if lr is None else lr
        a_m, a_v, b_m, b_v = self._bufs
        self.swapper.swap_in_async(0, a_m[:sizes[0]], a_v[:sizes[0]])
        for i in range(n_leaves):
            self.swapper.wait_swap_in()
            cur_m, cur_v = a_m[:sizes[i]], a_v[:sizes[i]]
            if i + 1 < n_leaves:  # the next leaf's read overlaps this update
                self.swapper.swap_in_async(i + 1, b_m[:sizes[i + 1]], b_v[:sizes[i + 1]])
            flat = params[i].reshape(-1)
            g32 = np.ascontiguousarray(host_view(grads[i], "the gradient").reshape(-1), np.float32)
            self.inner.lib.ds_adam_update(
                _f32p(flat), _f32p(g32), _f32p(cur_m), _f32p(cur_v), flat.size,
                self.inner.step_count, use_lr, self.inner.betas[0], self.inner.betas[1],
                self.inner.eps, self.inner.weight_decay, int(self.inner.adamw_mode), 1)
            self.swapper.wait_swap_out()  # the previous write-back first
            self.swapper.swap_out_async(i, cur_m, cur_v)
            a_m, b_m = b_m, a_m
            a_v, b_v = b_v, a_v
        self.swapper.wait_swap_out()
        return params

    @property
    def step_count(self) -> int:
        return self.inner.step_count

    def state_dict(self) -> dict:
        """The moments read back off disk into the dict, so that a resume
        works on another machine or swap dir."""
        state = {}
        h = self.swapper.read_handle
        for i, n in self.swapper._sizes.items():
            m = np.empty(n, np.float32)
            v = np.empty(n, np.float32)
            mp, vp = self.swapper._paths(i)
            check_io(int(h.sync_pread(m, mp) != 0) + int(h.sync_pread(v, vp) != 0), "moment read-back")
            state[str(i)] = {"m": m, "v": v}
        return {"step": self.inner.step_count, "swap_dir": str(self.swapper.swap_dir),
                "state": state}

    def load_state_dict(self, sd: dict) -> None:
        self.inner.step_count = int(sd["step"])
        state = sd.get("state", {})
        if state:
            sizes = []
            for i in sorted(int(k) for k in state):
                m, v = state[str(i)]["m"], state[str(i)]["v"]
                m = np.asarray(host_view(m), np.float32)
                v = np.asarray(host_view(v), np.float32)
                sizes.append(m.size)
                mp, vp = self.swapper._paths(i)
                self.swapper.write_handle.pwrite(m, mp)
                self.swapper.write_handle.pwrite(v, vp)
            check_io(self.swapper.write_handle.wait(), "moment restore writes")
            self.swapper._sizes = {i: n for i, n in enumerate(sizes)}
            self._resumed = True
            self._initialized = False  # the next step keeps the restored files

    def reset_state(self) -> None:
        self.inner.reset_state()
        self._initialized = False
        self._resumed = False
