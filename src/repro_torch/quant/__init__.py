"""Weight-only int8 quantization for serving (the port of `repro.quant`)."""
from repro_torch.quant.quant import (
    dequantize,
    dequantize_leaf,
    dequantize_params,
    quantization_error,
    quantize_leaf,
    quantize_named,
    quantize_params,
)

__all__ = [
    "dequantize",
    "dequantize_leaf",
    "dequantize_params",
    "quantization_error",
    "quantize_leaf",
    "quantize_named",
    "quantize_params",
]
