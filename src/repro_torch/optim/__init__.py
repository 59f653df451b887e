"""Optimisation-side helpers of the port: AdamW with its cosine schedule
and clipping (``adamw``), the gradient codecs of the train launcher and
the int8 weight calibration of the ``precision="int8"`` unlearning path
(``compression``)."""
from . import compression  # noqa: F401
from .adamw import (AdamState, AdamWConfig, adamw_update,  # noqa: F401
                    cosine_lr, global_norm, init_adamw, make_train_step,
                    value_and_grad)
from .compression import (INT8_SWEEP_RTOL, Int8Codec,  # noqa: F401
                          Q8_MIN_SCALE, TopKCodec, q8_dequantize,
                          q8_dequantize_tree, q8_fakequant,
                          q8_fakequant_tree, q8_quantize, q8_quantize_tree,
                          q8_scales)
