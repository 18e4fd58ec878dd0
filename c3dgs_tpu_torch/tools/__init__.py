"""Tools of the port: `dma_probe` (python -m c3dgs_tpu_torch.tools.dma_probe)."""
