"""Build and load the port's host libraries (counterpart of
``deepspeed_tpu/ops/op_builder/builder.py``: ``OpBuilder``,
``CPUAdamBuilder``, ``AsyncIOBuilder``).

The host Adam of ZeRO-Offload and the async file I/O of ZeRO-Infinity are
C++ for the CPU, not GPU kernels. Their sources are the port's own copies
under ``deepspeed_tpu_torch/csrc/host/``; each is compiled by ``g++`` (or
``$CXX``) with the JAX package's flags (``-O3 -std=c++17 -fPIC -shared
-pthread -march=native``, plus ``-mavx2 -mfma`` for Adam), so the same source
gives the same bits, into ``build/deepspeed_tpu_torch/host/`` under a hash of
the source and the flags, and loaded with :mod:`ctypes` on first use. A
failed build raises; nothing falls back to another optimizer. Nothing is
built at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
HOST_CSRC_DIR = PACKAGE_DIR / "csrc" / "host"
HOST_BUILD_DIR = PACKAGE_DIR.parent / "build" / "deepspeed_tpu_torch" / "host"

_lock = threading.Lock()


class OpBuilder:
    """One host library: its sources, flags, cached build and C
    declarations."""

    NAME = "base"
    SOURCES: tuple = ()

    def cxx_args(self) -> List[str]:
        return ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-march=native"]

    def compiler(self) -> str:
        return os.environ.get("CXX", "g++")

    def is_compatible(self) -> bool:
        return shutil.which(self.compiler()) is not None

    def absolute_sources(self) -> List[Path]:
        return [HOST_CSRC_DIR / s for s in self.SOURCES]

    def _hash(self) -> str:
        h = hashlib.sha256()
        for src in self.absolute_sources():
            h.update(src.read_bytes())
        h.update(" ".join([self.compiler()] + self.cxx_args()).encode())
        return h.hexdigest()[:16]

    def lib_path(self) -> Path:
        return HOST_BUILD_DIR / f"lib{self.NAME}-{self._hash()}.so"

    def build(self) -> Path:
        """Compile the library unless it is cached; raises with the
        compiler's output when the build fails. Concurrent builders each
        compile into their own file and rename it into place."""
        out = self.lib_path()
        if out.exists():
            return out
        if not self.is_compatible():
            raise RuntimeError(f"host library {self.NAME}: no C++ compiler ({self.compiler()!r} "
                               f"not on PATH)")
        HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = ([self.compiler()] + self.cxx_args() + [str(s) for s in self.absolute_sources()]
               + ["-o", str(tmp)])
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"build of host library {self.NAME} failed ({' '.join(cmd)}):\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
        return out

    _lib: Optional[ctypes.CDLL] = None

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if it is not cached."""
        cls = type(self)
        with _lock:
            if cls._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                cls._lib = lib
        return cls._lib

    def _declare(self, lib: ctypes.CDLL) -> None:
        """Subclasses declare argtypes and restypes here."""


class CPUAdamBuilder(OpBuilder):
    """``csrc/host/cpu_adam.cpp``: ``ds_adam_update``,
    ``ds_adam_update_copy_bf16``, ``ds_adagrad_update``."""

    NAME = "cpu_adam"
    SOURCES = ("cpu_adam.cpp",)

    def cxx_args(self):
        return super().cxx_args() + ["-mavx2", "-mfma"]

    def _declare(self, lib):
        f32p = ctypes.POINTER(ctypes.c_float)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.ds_adam_update.argtypes = [f32p, f32p, f32p, f32p, ctypes.c_int64, ctypes.c_int32,
                                       ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                       ctypes.c_float, ctypes.c_int32, ctypes.c_int32]
        lib.ds_adam_update.restype = None
        lib.ds_adam_update_copy_bf16.argtypes = lib.ds_adam_update.argtypes[:4] + [u16p] + \
            lib.ds_adam_update.argtypes[4:]
        lib.ds_adam_update_copy_bf16.restype = None
        lib.ds_adagrad_update.argtypes = [f32p, f32p, f32p, ctypes.c_int64, ctypes.c_float,
                                          ctypes.c_float, ctypes.c_float]
        lib.ds_adagrad_update.restype = None


class AsyncIOBuilder(OpBuilder):
    """``csrc/host/ds_aio.cpp``: the thread-pool file I/O handle."""

    NAME = "ds_aio"
    SOURCES = ("ds_aio.cpp",)

    def _declare(self, lib):
        lib.aio_handle_create.argtypes = [ctypes.c_int]
        lib.aio_handle_create.restype = ctypes.c_void_p
        lib.aio_handle_create2.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.aio_handle_create2.restype = ctypes.c_void_p
        lib.aio_handle_destroy.argtypes = [ctypes.c_void_p]
        lib.aio_handle_destroy.restype = None
        lib.aio_pwrite_async.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                                         ctypes.c_int64]
        lib.aio_pwrite_async.restype = None
        lib.aio_pread_async.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
                                        ctypes.c_int64]
        lib.aio_pread_async.restype = None
        lib.aio_wait.argtypes = [ctypes.c_void_p]
        lib.aio_wait.restype = ctypes.c_int
        lib.aio_direct_fallbacks.argtypes = [ctypes.c_void_p]
        lib.aio_direct_fallbacks.restype = ctypes.c_int64
        lib.aio_write_sync.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
        lib.aio_write_sync.restype = ctypes.c_int
        lib.aio_read_sync.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
        lib.aio_read_sync.restype = ctypes.c_int


#: the host libraries, by name
ALL_BUILDERS = {CPUAdamBuilder.NAME: CPUAdamBuilder, AsyncIOBuilder.NAME: AsyncIOBuilder}


def build_all() -> dict:
    """Build (or find cached) every host library; ``{name: path}``."""
    return {name: cls().build() for name, cls in ALL_BUILDERS.items()}
