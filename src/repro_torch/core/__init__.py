"""Numeric core: minifloat formats, block quantization, the FP4 matmul."""
