"""Tensor ops of the port (quaternions, camera math, SH, losses, fake-quant)."""
