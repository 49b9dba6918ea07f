from .device import (
    bincount_kernel,
    f32_div_exact,
    f32_mul_exact,
    f32_sqrt_exact,
    default_hist_bins,
    dequantize_kernel,
    encode_step,
    encode_step_chunk,
    encode_step_from_q,
    minmax_chunk_kernel,
    parallelogram_predict_kernel,
    quantize_kernel,
    quantize_rows_kernel,
    quantized_range_chunk_kernel,
    unpack12_kernel,
    unzigzag_kernel,
    wrapped_difference_kernel,
    zigzag_kernel,
)
from .gathers import build_parallelogram_gathers

__all__ = [
    "bincount_kernel", "default_hist_bins", "dequantize_kernel",
    "f32_div_exact", "f32_mul_exact", "f32_sqrt_exact",
    "encode_step", "encode_step_chunk", "encode_step_from_q",
    "minmax_chunk_kernel", "parallelogram_predict_kernel", "quantize_kernel",
    "quantize_rows_kernel", "quantized_range_chunk_kernel",
    "unpack12_kernel", "unzigzag_kernel", "wrapped_difference_kernel",
    "zigzag_kernel",
    "build_parallelogram_gathers",
]
