"""Device (PyTorch) compute plane of the port: the analysis lattices."""
