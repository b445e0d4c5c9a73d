"""Plain PyTorch references: import nothing of the port and nothing of JAX."""
