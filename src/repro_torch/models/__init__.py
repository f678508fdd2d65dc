"""Model configuration, layers, the dense transformer and the registry."""
