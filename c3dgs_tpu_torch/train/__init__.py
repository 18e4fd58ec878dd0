"""Training of the port: render_scene, train_step with Adam, densification."""
