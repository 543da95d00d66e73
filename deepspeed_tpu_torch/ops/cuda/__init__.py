"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (``flash_attention``: K1 forward, K4 backward and K3 decode;
``quant_matmul``: K2; ``moe_dispatch``: K5; ``sparse_attention``: K6 forward
and backward), with the build in ``build``.

``LAUNCHES`` counts the kernel launches of each library (K1 and K3 at head
dims 96 and 256 are libraries of their own, ``build.VARIANTS``): a wrapper
adds one where it launches its kernel and nowhere else (the plain versions on CPU
tensors do not count), so a run can show which kernels its path went
through."""

LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0, "flash_decode": 0, "quant_matmul": 0,
            "moe_permute": 0, "sparse_fwd": 0, "sparse_bwd": 0, "flash_fwd_d96": 0,
            "flash_fwd_d256": 0, "flash_decode_d96": 0, "flash_decode_d256": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches() -> dict:
    return dict(LAUNCHES)
