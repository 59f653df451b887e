"""Optimisation-side helpers of the port: the int8 weight calibration of
the ``precision="int8"`` unlearning path (``compression``)."""
from . import compression  # noqa: F401
from .compression import (INT8_SWEEP_RTOL, Q8_MIN_SCALE,  # noqa: F401
                          q8_dequantize, q8_dequantize_tree, q8_fakequant,
                          q8_fakequant_tree, q8_quantize, q8_quantize_tree,
                          q8_scales)
