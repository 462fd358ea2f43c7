"""ELL packing and the hand-written repair kernels with their plain
PyTorch versions."""
