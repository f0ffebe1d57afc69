"""PyTorch/CUDA port of the POP stack (``src/repro`` is the JAX reference).

Module paths mirror ``src/repro``: ``repro_torch/core/pdhg.py`` is the
counterpart of ``repro/core/pdhg.py``, and so on.  The package imports
``torch`` and numpy only — never ``jax`` and nothing of ``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device present the default raises instead
of falling back.  On CPU tensors the PDHG half-steps take their plain
PyTorch versions (``kernels/ref.py``); on CUDA tensors they launch the
hand-written kernels in ``kernels/csrc/``.
"""
