from .repdepth import RepDepth, cast_compute, init_weights
from .replknet import REPLK_CONFIGS, RepLKNet, num_ch_enc

__all__ = ["RepDepth", "RepLKNet", "REPLK_CONFIGS", "cast_compute",
           "init_weights", "num_ch_enc"]
