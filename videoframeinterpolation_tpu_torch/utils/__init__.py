"""Host utilities of the port: the YAML subset, flow rendering and the training logger."""
