"""tpumr_torch: the PyTorch and CUDA port of tpumr."""
