"""Tensor ops of the port (quaternions, camera math, SH, metrics, fake-quant)."""
