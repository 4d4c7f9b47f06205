"""Hand-written CUDA kernels (``csrc/``), their ctypes wrappers, their
plain PyTorch versions (``ref``) and the dispatch between them (``ops``)."""
