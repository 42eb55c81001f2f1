from .tracker import KLTracker, set_verbosity

__all__ = ["KLTracker", "set_verbosity"]
