"""Render path of the port: preprocess, binning, the packed forward and
backward kernels, the per-slot gradient reduction and image assembly."""
