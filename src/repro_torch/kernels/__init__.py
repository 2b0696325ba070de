"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(``ref.py``); ``ops.py`` dispatches on the tensor's device."""
