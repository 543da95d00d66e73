"""Quantization ops (counterpart of ``deepspeed_tpu/ops/quantizer``)."""

from deepspeed_tpu_torch.ops.quantizer.core import (QuantParams, dequantize, fake_quantize,
                                                    pack_int4, quantize, quantize_lastaxis,
                                                    quantized_reduction, swizzle_quant,
                                                    unpack_int4)

#: the reference's ``ds_quantizer`` entry: fake quantization
ds_quantizer = fake_quantize

__all__ = ["QuantParams", "quantize", "quantize_lastaxis", "dequantize", "fake_quantize",
           "pack_int4", "unpack_int4", "swizzle_quant", "quantized_reduction", "ds_quantizer"]
