"""The Python side of the async file I/O engine ``csrc/host/ds_aio.cpp``
(counterpart of ``deepspeed_tpu/ops/aio/aio_handle.py``)."""

import numpy as np
import torch

from deepspeed_tpu_torch.ops.op_builder import AsyncIOBuilder


def check_io(errors: int, what: str) -> None:
    """Raise ``OSError`` when ``errors`` file ops of ``what`` failed."""
    if errors:
        raise OSError(f"{errors} of the {what} failed")


def _buffer(buf) -> np.ndarray:
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu":
            raise ValueError(f"an aio buffer must live on the host, got a tensor on {buf.device}")
        buf = buf.detach().view(torch.uint8).numpy() if buf.dtype == torch.bfloat16 else buf.detach().numpy()
    return buf


class AsyncIOHandle:
    """Thread-pool async reads and writes of whole files from and into host
    buffers (numpy arrays or CPU tensors). A buffer must stay alive, and
    unmodified for a write, until ``wait()`` returns; the handle keeps a
    reference until then.

    ``use_direct=True`` bypasses the page cache with O_DIRECT through
    aligned bounce buffers. Where the filesystem refuses O_DIRECT (tmpfs),
    or a transfer is below one 4 KiB sector, the op runs buffered, as the
    C++ engine documents; :meth:`direct_fallbacks` counts those ops."""

    def __init__(self, n_threads: int = 4, use_direct: bool = False):
        self.lib = AsyncIOBuilder().load()
        self._h = self.lib.aio_handle_create2(int(n_threads), 1 if use_direct else 0)
        self.use_direct = use_direct
        self._pending = []

    def pwrite(self, buf, path) -> None:
        buf = np.ascontiguousarray(_buffer(buf))
        self._pending.append(buf)
        self.lib.aio_pwrite_async(self._h, str(path).encode(), buf.ctypes.data, buf.nbytes)

    def pread(self, buf, path) -> None:
        buf = _buffer(buf)
        if not (buf.flags.c_contiguous and buf.flags.writeable):
            raise ValueError("pread needs a contiguous writable buffer")
        self._pending.append(buf)
        self.lib.aio_pread_async(self._h, str(path).encode(), buf.ctypes.data, buf.nbytes)

    def wait(self) -> int:
        """Block until every submitted op completes; the count of failed
        ops since the last wait."""
        errors = self.lib.aio_wait(self._h)
        self._pending.clear()
        return errors

    def direct_fallbacks(self) -> int:
        """Direct-requested ops that ran buffered since the handle was made.
        Raises on a closed handle: "could not check" never reads as
        "none"."""
        if self._h is None:
            raise RuntimeError("direct_fallbacks() on a closed AsyncIOHandle")
        return int(self.lib.aio_direct_fallbacks(self._h))

    def sync_pwrite(self, buf, path) -> int:
        buf = np.ascontiguousarray(_buffer(buf))
        return self.lib.aio_write_sync(str(path).encode(), buf.ctypes.data, buf.nbytes)

    def sync_pread(self, buf, path) -> int:
        buf = _buffer(buf)
        return self.lib.aio_read_sync(str(path).encode(), buf.ctypes.data, buf.nbytes)

    def close(self) -> None:
        if self._h is not None:
            self.wait()
            self.lib.aio_handle_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 (interpreter teardown)
            pass
