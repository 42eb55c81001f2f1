from .tracker import KLTracker, set_verbosity
from .pipeline import track_sequence_replace_exact

__all__ = ["KLTracker", "set_verbosity", "track_sequence_replace_exact"]
