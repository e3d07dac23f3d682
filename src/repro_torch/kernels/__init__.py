"""Hand-written CUDA kernels of the port, one folder per kernel family:
``csrc/`` holds the source, ``ops.py`` the wrapper with its launch count,
``ref.py`` the plain PyTorch version."""
