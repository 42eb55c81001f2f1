from .viz import feature_overlay, write_feature_list_ppm

__all__ = ["feature_overlay", "write_feature_list_ppm"]
