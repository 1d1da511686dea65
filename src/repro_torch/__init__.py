"""PyTorch + CUDA port of the PlaceIT reproduction (``repro``).

The package mirrors ``repro``'s layout (``kernels/``, ``core/``) so each
module's counterpart is found at the same relative path.  It imports
``torch`` and numpy only; the CUDA kernels under ``kernels/csrc`` are
built with ``nvcc`` at first use on a machine with a card.
"""
