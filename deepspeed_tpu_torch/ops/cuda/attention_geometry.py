"""Block geometry of the port's kernels: the attention kernels' head dims,
the dequant GEMM's bodies and split plan (K2), and flash decode's chunking
of the cache (K3, whose plan the kernel computes on the device from the
slots' lengths; :func:`decode_blocks` states it on the host).

The JAX package resolves its flash-attention blocks through layered TPU v5e
tables (``deepspeed_tpu/ops/pallas/attention_geometry.py``). Those tables
describe VMEM and the MXU and do not carry over: the Hopper kernels have
their own tiles, compiled into ``csrc/`` (each source's note gives them),
and they mask a ragged last tile themselves, so no length has to be
divisible by a block."""

#: ``csrc/quant_matmul.cu``: the C entry's body codes, each body's output
#: tile (rows, columns), the K step every split is a multiple of, the
#: largest M the decode body takes, the longest K range it stages x for,
#: and the most splits of the tensor-core bodies (one thread-block cluster)
QMM_BODIES = ("fma", "gemv", "mma")
QMM_TILES = {"fma": (32, 64), "gemv": (16, 128), "mma": (128, 64)}
QMM_K_STEP = 64
QMM_GEMV_MAX_M = 16
QMM_GEMV_MAX_K_CHUNK = 512
QMM_MAX_CLUSTER = 8

#: ``csrc/flash_decode.cu``: the C entry's body codes, keys per block of
#: each body (the tile body's at head dim 256: ``DECODE_TILE_CHUNK_D256``),
#: and query rows per block of the tile body
DECODE_BODIES = ("rows", "tiles")
DECODE_CHUNK = {"rows": 64, "tiles": 256}
DECODE_TILE_CHUNK_D256 = 128
DECODE_TILE_ROWS = 16

#: head dims the serving kernels K1 and K3 are instantiated for (GPT-2
#: 125m/350m, OPT, GPT-Neo, Falcon-7b and BLOOM use 64, the LLaMA family
#: and Qwen2 128, GPT-NeoX-20b 96, GPT-J-6b 256; each more width is another
#: template instance and more build time, and 96 and 256 are libraries of
#: their own, ``build.VARIANTS``). Their tiles per head dim are compile-time
#: constants of the sources (``FwdTile``, ``Dim``): no wrapper sizes
#: anything by them but K3's workspace (:func:`decode_chunk`).
KERNEL_HEAD_DIMS = (64, 96, 128, 256)
#: head dims the flash backward K4 is instantiated for (``BwdTile``):
#: training at 96 and 256 is ROADMAP.md Queue B item 2
TRAIN_HEAD_DIMS = (64, 128)
#: head dims the block-sparse kernels K6 take (``csrc/sparse_fwd.cu``)
SPARSE_HEAD_DIMS = (64,)


def check_head_dim(what: str, d: int, dims=KERNEL_HEAD_DIMS) -> None:
    """Raise ``ValueError`` for a head dim the CUDA kernels are not built
    for (K1 and K3: ``KERNEL_HEAD_DIMS``; K4 passes ``TRAIN_HEAD_DIMS``);
    the wrappers call it before they build or launch anything."""
    if d not in dims:
        later = (" (the flash backward at this head dim waits in ROADMAP.md Queue B item 2)"
                 if dims is TRAIN_HEAD_DIMS and d in KERNEL_HEAD_DIMS else "")
        raise ValueError(f"{what}: head_dim {d} not in the kernel's {dims}{later}")


def kernel_library(kernel: str, d: int) -> str:
    """The library of ``kernel`` (``"flash_fwd"`` or ``"flash_decode"``) at
    head dim ``d``: the source's own for 64 and 128, its ``_d<d>`` variant
    for 96 and 256 (``build.VARIANTS``); the key of its launch count."""
    return kernel if d in (64, 128) else f"{kernel}_d{d}"


def decode_chunk(body: str, d: int = 64) -> int:
    """Keys per block of K3's ``body`` at head dim ``d``."""
    return DECODE_TILE_CHUNK_D256 if body == "tiles" and d == 256 else DECODE_CHUNK[body]


def decode_body(bf16: bool, lq: int) -> str:
    """K3's body for a call: the tensor cores for bf16 with more than one
    query row (a prefill chunk), else one query row per block."""
    return "tiles" if bf16 and lq > 1 else "rows"


def decode_row_limit(length: int, lq: int, p_len: int, row: int) -> int:
    """Keys ``[0, limit)`` that query row ``row`` of a slot of ``length``
    reads: at or before its position ``length - lq + row``, inside the pool
    of ``p_len`` (a parked slot's length is ``p_len + lq``)."""
    return max(0, min(min(max(length, 0), p_len), length - lq + row + 1))


def decode_blocks(length: int, lq: int, p_len: int, body: str, d: int = 64):
    """The blocks of one (slot, head) that K3 runs, as the kernel plans them
    on the device from the slot's length: ``(rows, keys)`` pairs, each a
    range of query rows and the chunk of keys the block reads for them
    (clipped to what the rows read), or ``(rows, None)`` for the block that
    writes the zeros of rows with no live key. Every other block of the grid
    returns before it loads anything."""
    chunk = decode_chunk(body, d)
    tile = DECODE_TILE_ROWS if body == "tiles" else 1
    blocks = []
    for row0 in range(0, lq, tile):
        rows = range(row0, min(lq, row0 + tile))
        limit = decode_row_limit(length, lq, p_len, rows[-1])
        if limit == 0:
            blocks.append((rows, None))
        for c in range(-(-limit // chunk)):
            blocks.append((rows, range(c * chunk, min(limit, (c + 1) * chunk))))
    return blocks


def pick_block(length: int, preferred: int = 512) -> int:
    """Largest block from the standard chain that tiles ``length``."""
    for blk in sorted({preferred, 1024, 512, 256, 128, 64, 32, 16, 8}, reverse=True):
        if blk <= preferred and blk <= length and length % blk == 0:
            return blk
    return length
