from .linalg import gj_solve_spd, inv3
from .parity import detection_epochs, table_parity_stats
from .viz import feature_overlay, write_feature_list_ppm

__all__ = ["feature_overlay", "write_feature_list_ppm", "gj_solve_spd",
           "inv3", "detection_epochs", "table_parity_stats"]
