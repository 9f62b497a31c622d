"""Audio input of the port."""
