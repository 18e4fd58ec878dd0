"""Evaluation of the port: render_full and render_and_eval."""
