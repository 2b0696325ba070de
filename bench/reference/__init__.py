"""The benchmark's plain reference: the served models in PyTorch alone."""
