"""Scene model of the port."""
