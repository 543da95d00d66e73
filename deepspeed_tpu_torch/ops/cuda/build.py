"""Build and load the port's hand-written CUDA kernels.

Each ``deepspeed_tpu_torch/csrc/<name>.cu`` is compiled on its own by
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface (and K1's and K3's sources once more for each further head dim,
``VARIANTS``), cached under ``build/deepspeed_tpu_torch/`` by a hash of the
sources and flags, and loaded with :mod:`ctypes` on first use. Every pointer
and the CUDA stream cross the boundary as ``c_void_p``; every C entry returns
``cudaGetLastError()`` after its launches and :func:`check` raises when that
is not 0.

Nothing is compiled or loaded at import time: the CPU tests import every
module of the package on a machine without ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "deepspeed_tpu_torch"

#: libraries built from another library's source for one head dim each
#: (``-DDS_HEAD_DIM``), so that every instance is an ``nvcc`` of its own and
#: the parallel build runs them side by side: name -> (source, extra flags)
VARIANTS = {f"{src}_d{d}": (src, (f"-DDS_HEAD_DIM={d}",))
            for src in ("flash_fwd", "flash_decode") for d in (96, 256)}

#: the kernel libraries: one per source file, then the variants
KERNELS = ("flash_fwd", "flash_bwd", "flash_decode", "quant_matmul", "moe_permute", "sparse_fwd",
           "sparse_bwd") + tuple(VARIANTS)


def source_of(name: str):
    """``(source name, extra nvcc flags)`` of library ``name``."""
    return VARIANTS.get(name, (name, ()))

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: dtype codes of ``csrc/common.cuh``
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: the dtypes every kernel takes; K1, K4 and K5 also take fp16
#: (``FP16_DTYPES``), while K2, K3 and K6 wait for their fp16 instances
#: (ROADMAP.md Queue B item 3)
BASE_DTYPES = (torch.float32, torch.bfloat16)
FP16_DTYPES = BASE_DTYPES + (torch.float16,)

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

#: C signatures of each library's entry point (``restype`` is always int)
SIGNATURES = {
    "flash_fwd": ("ds_flash_fwd",
                  [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I]
                  + [_LL] * 9 + [_P]),
    "flash_bwd": ("ds_flash_bwd",
                  [_P] * 11 + [_I, _I, _I, _I, _I, _I, _F, _I, _I] + [_LL] * 12 + [_P]),
    "flash_decode": ("ds_flash_decode",
                     [_P] * 9 + [_I] * 7 + [_F] + [_LL] * 15 + [_P]),
    "quant_matmul": ("ds_quant_matmul",
                     [_P] * 6 + [_I] * 7 + [_LL, _I, _I, _P]),
    "moe_permute": ("ds_moe_permute", [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "sparse_fwd": ("ds_sparse_fwd", [_P] * 8 + [_I] * 7 + [_F, _I] + [_LL] * 9 + [_P]),
    "sparse_bwd": ("ds_sparse_bwd", [_P] * 16 + [_I] * 8 + [_F, _I] + [_LL] * 12 + [_P]),
}

_lock = threading.Lock()
_loaded: Dict[str, "KernelLibrary"] = {}
_counters: Dict[torch.device, torch.Tensor] = {}


class KernelLibrary:
    """One loaded kernel library: its C entry point and error strings."""

    def __init__(self, name: str, path: Path):
        self.name = name
        self.path = path
        self._cdll = ctypes.CDLL(str(path))
        source = source_of(name)[0]
        entry, argtypes = SIGNATURES[source]
        self.entry = getattr(self._cdll, entry)
        self.entry.argtypes = argtypes
        self.entry.restype = ctypes.c_int
        self._err = getattr(self._cdll, f"ds_{source}_error_string")
        self._err.argtypes = [ctypes.c_int]
        self._err.restype = ctypes.c_char_p

    def __call__(self, *args) -> None:
        check(self, self.entry(*args))

    def error_string(self, status: int) -> str:
        return self._err(status).decode()


def check(lib: KernelLibrary, status: int) -> None:
    """Raise when a C entry reported a CUDA error (a refused launch never
    runs, and ``torch.cuda.synchronize()`` would not report it)."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {lib.name} failed: error {status} "
                           f"({lib.error_string(status)})")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
                       "kernels are built from source on the machine with the GPU")


def _digest(name: str) -> str:
    source, extra = source_of(name)
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS + extra).encode())
    for path in [CSRC_DIR / f"{source}.cu"] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    if name not in KERNELS:
        raise ValueError(f"unknown kernel library {name!r}; known: {KERNELS}")
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names: Iterable[str] = KERNELS, verbose: bool = False) -> Dict[str, float]:
    """Compile every library in ``names`` that is not cached yet, one
    ``nvcc`` process per source, all started together. Returns the wall
    seconds each took, from its start to its own exit (0.0 when it was
    cached). Raises with the compiler's output when one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        source, extra = source_of(name)
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC_DIR)]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC_DIR / f"{source}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out, time.perf_counter())
    logs = {}

    def drain(name, proc, t0):
        logs[name] = proc.communicate()[0]
        seconds[name] = time.perf_counter() - t0

    readers = [threading.Thread(target=drain, args=(name, proc, t0))
               for name, (proc, _, _, t0) in procs.items()]
    for r in readers:
        r.start()
    for r in readers:
        r.join()
    failures = []
    for name, (proc, tmp, out, _) in procs.items():
        log = logs[name]
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name} (exit {proc.returncode}) ---\n{log}")
            continue
        if verbose and log:
            print(f"--- nvcc {name} ---\n{log}", flush=True)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def load(name: str) -> KernelLibrary:
    """The loaded library for ``name``, built first if it is not cached."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = _loaded[name] = KernelLibrary(name, path)
        return lib


def dtype_code(t: torch.Tensor, what: str, dtypes=BASE_DTYPES) -> int:
    """The ``csrc/common.cuh`` code of ``t``'s dtype, which must be one of
    the kernel's ``dtypes``; ``ValueError`` otherwise."""
    if t.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        later = (" (its fp16 instance waits in ROADMAP.md Queue B item 3)"
                 if t.dtype == torch.float16 else "")
        raise ValueError(f"{what}: the CUDA kernel takes {names}, got {t.dtype}{later}")
    return DTYPE_CODES[t.dtype]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def counters(device: torch.device, n: int) -> torch.Tensor:
    """A zeroed int32 buffer of at least ``n`` arrival counters on
    ``device``, shared by the kernels that finish a split reduction in its
    last block (K3, K2's general body: ``csrc/common.cuh`` ``arrive_last``). Each such
    launch returns every counter it used to 0, so the buffer is zeroed again
    for the next launch on the stream; launches that share it must run on
    one stream, in turn, as the port's do."""
    with _lock:
        buf = _counters.get(device)
        if buf is None or buf.numel() < n:
            buf = _counters[device] = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        return buf
