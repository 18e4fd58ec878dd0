"""Sensitivity-weighted VQ compression (port of c3dgs_tpu/compress)."""
