"""Attention block geometry for the port.

The JAX package resolves its flash-attention blocks through layered TPU v5e
tables (``deepspeed_tpu/ops/pallas/attention_geometry.py``). Those tables
describe VMEM and the MXU and do not carry over: the Hopper kernels have
their own tiles, compiled into ``csrc/`` (each source's note gives them),
and they mask a ragged last tile themselves, so no length has to be
divisible by a block."""

#: ``csrc/quant_matmul.cu``: output tile and K step (the wrapper sizes the
#: split over K from them)
QMM_BLOCK_M = 32
QMM_BLOCK_N = 64
QMM_BLOCK_K = 32

#: head dims the attention kernels are instantiated for (GPT-2 125m/350m/xl
#: use 64; each more width is another template instance and more build time)
KERNEL_HEAD_DIMS = (64,)


def pick_block(length: int, preferred: int = 512) -> int:
    """Largest block from the standard chain that tiles ``length``."""
    for blk in sorted({preferred, 1024, 512, 256, 128, 64, 32, 16, 8}, reverse=True):
        if blk <= preferred and blk <= length and length % blk == 0:
            return blk
    return length
