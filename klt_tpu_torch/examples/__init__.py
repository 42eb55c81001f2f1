"""Runnable examples of the port (python -m klt_tpu_torch.examples.<name>)."""
