"""Kernels of the port: hand-written CUDA for Hopper beside their plain
PyTorch versions.  Import ``ops`` of a family for its public function."""
