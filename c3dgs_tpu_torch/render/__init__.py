"""Serving render path of the port: preprocess, binning, the packed forward
kernel and image assembly."""
