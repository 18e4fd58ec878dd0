"""The port's command-line entry points (python -m c3dgs_tpu_torch.cli.<name>)."""
