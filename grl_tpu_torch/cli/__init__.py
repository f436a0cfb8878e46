"""Command-line entry points: ``python -m grl_tpu_torch.cli.train`` and
``python -m grl_tpu_torch.cli.evaluate``."""
