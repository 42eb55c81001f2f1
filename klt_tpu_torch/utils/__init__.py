from .linalg import gj_solve_spd, inv3
from .viz import feature_overlay, write_feature_list_ppm

__all__ = ["feature_overlay", "write_feature_list_ppm", "gj_solve_spd",
           "inv3"]
