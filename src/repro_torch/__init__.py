"""PyTorch/CUDA port of the SOLE serving stack (``repro`` is the JAX
reference it is held against).

The package mirrors ``repro``'s module paths and names. It imports
``torch`` and ``numpy`` only — never ``jax`` and nothing of ``repro`` —
so it runs on a machine with no JAX installed. Entry points take an
explicit ``device`` and run on ``cuda`` unless the caller asks for the
CPU; the two hand-written Hopper kernels (paged Flash-E2Softmax and the
AILayerNorm quantize+norm) live in ``kernels/csrc`` and are built with
``nvcc`` on first use.
"""
