"""Hand-written Hopper kernels (``csrc/``), their ctypes wrappers and the
plain PyTorch versions they are held against (``ref.py``)."""
