"""Memory-mapped indexed token dataset (reference
``data_pipeline/data_sampling/indexed_dataset.py:617`` ``MMapIndexedDataset``).

Same capability — O(1) random access to variable-length token sequences from
two flat files without loading them — in two on-disk layouts:

* **native** (this repo's minimal format):
  ``<prefix>.bin``  raw tokens, back to back.
  ``<prefix>.idx``  header (magic ``DSTPUIDX``, version, dtype code,
                    count) + ``sizes`` (u32 per sequence) + ``pointers``
                    (u64 *element* offsets, count+1 of them).
* **megatron** (the Megatron-LM binary layout the reference inherits,
  ``indexed_dataset.py:617`` — magic ``MMIDIDX\\x00\\x00``): header
  (version u64, dtype code u8, sequence count u64, document count u64) +
  ``sizes`` (i32 per sequence) + ``pointers`` (i64 *byte* offsets, one
  per sequence) + ``doc_idx`` (i64 sequence indices of document starts).
  Reading it directly means corpora tokenized by Megatron/DeepSpeed
  preprocessing pipelines feed this engine without a conversion pass.

``MMapIndexedDataset`` sniffs the magic and reads either;
``MMapIndexedDatasetBuilder(..., fmt="megatron")`` writes the Megatron
layout (with ``end_document`` tracking) for round-trips and export.

Reads are ``np.memmap`` slices — the OS page cache is the shard buffer,
from which the host copies a batch to the card. The port's own copy of
``deepspeed_tpu/runtime/data_pipeline/data_sampling/indexed_dataset.py``:
files written by either package read back byte-equal in the other.
"""

import os
import struct
from typing import Sequence, Union

import numpy as np

_MAGIC = b"DSTPUIDX"
_VERSION = 1

#: Megatron-LM index magic + version (reference ``_HDR_MAGIC``)
_MEGATRON_MAGIC = b"MMIDIDX\x00\x00"
_MEGATRON_VERSION = 1

# stable on-disk dtype codes (reference ``dtypes`` table indexed_dataset.py:117)
_DTYPES = {1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32, 5: np.int64,
           6: np.float32, 7: np.float64, 8: np.uint16, 9: np.uint32}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

#: the Megatron table stops at uint16 (its vocab-size-driven pick)
_MEGATRON_DTYPES = {k: v for k, v in _DTYPES.items() if k <= 8}
_MEGATRON_DTYPE_CODES = {np.dtype(v): k for k, v in _MEGATRON_DTYPES.items()}


def find_fit_int_dtype(low: int, high: int):
    """Smallest integer dtype covering [low, high] (reference
    ``data_sampling/utils.py`` helper of the same name)."""
    for dt in (np.uint8, np.uint16, np.uint32) if low >= 0 else ():
        if high <= np.iinfo(dt).max:
            return dt
    for dt in (np.int8, np.int16, np.int32, np.int64):
        if np.iinfo(dt).min <= low and high <= np.iinfo(dt).max:
            return dt
    raise ValueError(f"no integer dtype fits [{low}, {high}]")


def data_file_path(prefix: str) -> str:
    return prefix + ".bin"


def index_file_path(prefix: str) -> str:
    return prefix + ".idx"


class MMapIndexedDatasetBuilder:
    """Streaming writer (reference ``MMapIndexedDatasetBuilder``
    indexed_dataset.py:570). ``fmt="megatron"`` emits the Megatron-LM
    binary layout instead of the native one — byte pointers + a
    ``doc_idx`` built from :meth:`end_document` calls. A builder that
    never calls ``end_document`` writes ONE document spanning the whole
    corpus (``doc_idx=[0, N]``) — call it per sequence for per-sequence
    documents."""

    def __init__(self, out_file_prefix: str, dtype=np.int32, fmt: str = "native"):
        if fmt not in ("native", "megatron"):
            raise ValueError(f"fmt must be 'native' or 'megatron', got {fmt!r}")
        self._prefix = out_file_prefix
        self._fmt = fmt
        self._dtype = np.dtype(dtype)
        codes = _MEGATRON_DTYPE_CODES if fmt == "megatron" else _DTYPE_CODES
        assert self._dtype in codes, f"unsupported dtype {dtype} for fmt={fmt}"
        self._bin = open(data_file_path(out_file_prefix), "wb")
        self._sizes = []
        self._doc_idx = [0]

    def add_item(self, tokens: Union[Sequence[int], np.ndarray]) -> None:
        arr = np.asarray(tokens, dtype=self._dtype)
        assert arr.ndim == 1, "items are 1-D token sequences"
        self._bin.write(arr.tobytes(order="C"))
        self._sizes.append(len(arr))

    def end_document(self) -> None:
        """Mark a document boundary (reference ``end_document``): the
        sequences added since the previous boundary form one document in
        the Megatron ``doc_idx``. No-op for the native layout."""
        self._doc_idx.append(len(self._sizes))

    def merge_file_(self, other_prefix: str) -> None:
        """Append another dataset with the same dtype (reference :595).
        In megatron format the other dataset's document boundaries are
        carried over (shifted by the current sequence count; an open
        document is closed first so shards never fuse across the seam) —
        a native-layout source contributes per-sequence documents."""
        other = MMapIndexedDataset(other_prefix)
        assert other._dtype == self._dtype, "dtype mismatch in merge"
        if self._fmt == "megatron" and self._doc_idx[-1] != len(self._sizes):
            self.end_document()
        base = len(self._sizes)
        with open(data_file_path(other_prefix), "rb") as f:
            while True:
                chunk = f.read(1 << 22)
                if not chunk:
                    break
                self._bin.write(chunk)
        self._sizes.extend(other.sizes.tolist())
        if self._fmt == "megatron":
            # other.doc_idx[0] is always 0 (the seam just closed above)
            self._doc_idx.extend(base + int(d) for d in other.doc_idx[1:])

    def finalize(self) -> None:
        self._bin.close()
        if self._fmt == "megatron":
            return self._finalize_megatron()
        sizes = np.asarray(self._sizes, dtype=np.uint32)
        pointers = np.zeros(len(sizes) + 1, dtype=np.uint64)
        np.cumsum(sizes, out=pointers[1:])
        with open(index_file_path(self._prefix), "wb") as f:
            f.write(_MAGIC)
            f.write(struct.pack("<IBQ", _VERSION, _DTYPE_CODES[self._dtype], len(sizes)))
            f.write(sizes.tobytes(order="C"))
            f.write(pointers.tobytes(order="C"))

    def _finalize_megatron(self) -> None:
        sizes = np.asarray(self._sizes, dtype=np.int32)
        # byte offsets, one per sequence (reference ``_get_pointers``)
        pointers = np.zeros(len(sizes), dtype=np.int64)
        if len(sizes) > 1:
            np.cumsum(sizes[:-1] * self._dtype.itemsize, out=pointers[1:])
        doc_idx = self._doc_idx
        if doc_idx[-1] != len(sizes):
            # close a still-open document (no trailing end_document());
            # with no end_document calls at all this yields [0, N] — one
            # document spanning the corpus (class docstring)
            doc_idx = doc_idx + [len(sizes)]
        doc_idx = np.asarray(doc_idx, dtype=np.int64)
        with open(index_file_path(self._prefix), "wb") as f:
            f.write(_MEGATRON_MAGIC)
            f.write(struct.pack("<Q", _MEGATRON_VERSION))
            f.write(struct.pack("<B", _MEGATRON_DTYPE_CODES[self._dtype]))
            f.write(struct.pack("<Q", len(sizes)))
            f.write(struct.pack("<Q", len(doc_idx)))
            f.write(sizes.tobytes(order="C"))
            f.write(pointers.tobytes(order="C"))
            f.write(doc_idx.tobytes(order="C"))


class MMapIndexedDataset:
    """Zero-copy random-access reader (reference ``MMapIndexedDataset``
    indexed_dataset.py:420). Sniffs the index magic: reads the native
    layout AND the Megatron-LM ``MMIDIDX`` layout (byte pointers +
    ``doc_idx``) — both normalize to *element*-offset ``pointers``
    internally, so ``__getitem__``/``get`` are layout-blind."""

    def __init__(self, path_prefix: str):
        self._prefix = path_prefix
        idx_path = index_file_path(path_prefix)
        with open(idx_path, "rb") as f:
            magic = f.read(len(_MEGATRON_MAGIC))
        if magic == _MEGATRON_MAGIC:
            self._fmt = "megatron"
            self._read_megatron_index(idx_path)
        elif magic[:len(_MAGIC)] == _MAGIC:
            self._fmt = "native"
            self._read_native_index(idx_path)
        else:
            raise AssertionError(f"{idx_path}: bad magic {magic[:len(_MAGIC)]!r} "
                                 f"(neither {_MAGIC!r} nor Megatron "
                                 f"{_MEGATRON_MAGIC!r})")
        if os.path.getsize(data_file_path(path_prefix)) == 0:
            # a legitimately empty dataset (e.g. a metric with no samples):
            # mmap rejects zero-byte files
            self._data = np.empty((0,), self._dtype)
        else:
            self._data = np.memmap(data_file_path(path_prefix), dtype=self._dtype, mode="r")

    def _read_native_index(self, idx_path: str) -> None:
        with open(idx_path, "rb") as f:
            f.read(len(_MAGIC))
            version, code, count = struct.unpack("<IBQ", f.read(13))
            assert version == _VERSION, f"unsupported index version {version}"
            self._dtype = np.dtype(_DTYPES[code])
            offset = f.tell()
        self._sizes = np.memmap(idx_path, dtype=np.uint32,
                                mode="r", offset=offset, shape=(count,))
        self._pointers = np.memmap(idx_path, dtype=np.uint64,
                                   mode="r", offset=offset + 4 * count, shape=(count + 1,))
        self._doc_idx = np.arange(count + 1, dtype=np.int64)

    def _read_megatron_index(self, idx_path: str) -> None:
        """The reference layout (indexed_dataset.py:617 ``Index``):
        version u64 | dtype u8 | seq count u64 | doc count u64 | sizes
        i32[count] | pointers i64[count] (BYTE offsets) | doc_idx
        i64[doc_count]."""
        with open(idx_path, "rb") as f:
            f.read(len(_MEGATRON_MAGIC))
            (version,) = struct.unpack("<Q", f.read(8))
            assert version == _MEGATRON_VERSION, \
                f"unsupported Megatron index version {version}"
            (code,) = struct.unpack("<B", f.read(1))
            assert code in _MEGATRON_DTYPES, f"unknown Megatron dtype code {code}"
            self._dtype = np.dtype(_MEGATRON_DTYPES[code])
            count, doc_count = struct.unpack("<QQ", f.read(16))
            offset = f.tell()
        self._sizes = np.memmap(idx_path, dtype=np.int32, mode="r",
                                offset=offset, shape=(count,))
        byte_pointers = np.memmap(idx_path, dtype=np.int64, mode="r",
                                  offset=offset + 4 * count, shape=(count,))
        self._doc_idx = np.memmap(idx_path, dtype=np.int64, mode="r",
                                  offset=offset + 4 * count + 8 * count,
                                  shape=(doc_count,))
        # normalize byte offsets -> element offsets (+ the final sentinel
        # the native layout stores explicitly)
        item = self._dtype.itemsize
        if count and (byte_pointers % item).any():
            raise AssertionError(f"{idx_path}: byte pointers not aligned to "
                                 f"dtype {self._dtype} (itemsize {item})")
        pointers = np.empty(count + 1, dtype=np.uint64)
        pointers[:count] = byte_pointers // item
        pointers[count] = (0 if not count
                           else pointers[count - 1] + np.uint64(self._sizes[-1]))
        self._pointers = pointers

    def __len__(self) -> int:
        return len(self._sizes)

    @property
    def sizes(self) -> np.ndarray:
        return self._sizes

    @property
    def doc_idx(self) -> np.ndarray:
        """Document boundaries as sequence indices (Megatron semantics;
        the native layout reports one document per sequence)."""
        return self._doc_idx

    @property
    def fmt(self) -> str:
        return self._fmt

    @property
    def dtype(self):
        return self._dtype

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            start, end = int(self._pointers[idx]), int(self._pointers[idx + 1])
            return np.asarray(self._data[start:end])
        if isinstance(idx, slice):
            return [self[i] for i in range(*idx.indices(len(self)))]
        raise TypeError(f"index must be int or slice, got {type(idx)}")

    def get(self, idx: int, offset: int = 0, length: int = None) -> np.ndarray:
        """Sub-sequence read without touching the rest (reference :512)."""
        start = int(self._pointers[idx]) + offset
        stop = int(self._pointers[idx + 1]) if length is None else start + length
        return np.asarray(self._data[start:stop])

    @staticmethod
    def exists(path_prefix: str) -> bool:
        return (os.path.exists(index_file_path(path_prefix))
                and os.path.exists(data_file_path(path_prefix)))
