from .pnm import read_pgm, write_pgm, read_ppm, write_ppm, write_float_pgm
from .features_io import (write_feature_list, write_feature_history,
                          write_feature_table, read_feature_list,
                          read_feature_history, read_feature_table)

__all__ = [
    "read_pgm", "write_pgm", "read_ppm", "write_ppm", "write_float_pgm",
    "write_feature_list", "write_feature_history", "write_feature_table",
    "read_feature_list", "read_feature_history", "read_feature_table",
]
