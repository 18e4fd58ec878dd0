"""Trainer of the port (render_scene only so far)."""
