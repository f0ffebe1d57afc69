"""Hand-written CUDA kernels for the PDHG half-steps, their plain PyTorch
versions (``ref.py``) and the dispatch between them (``ops.py``)."""
