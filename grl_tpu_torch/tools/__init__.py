"""Measurement scripts of the port, run with ``python3 -m grl_tpu_torch.tools.<name>``."""
