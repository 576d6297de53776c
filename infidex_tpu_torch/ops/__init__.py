"""Device modules of the port: plain PyTorch, and the wrappers of the
hand-written CUDA kernels under ``csrc/`` (``_kernels.py``)."""
