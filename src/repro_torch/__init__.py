"""PyTorch port of ``repro`` for NVIDIA Hopper.

The layout mirrors the JAX package (``models/``, ``kernels/``, ``serve/``,
``launch/``, ``obs/``, ``core/``, ``configs/``).  The port imports neither
JAX nor ``repro``: it keeps its own copies of the host-side modules it
needs.  Hand-written CUDA kernels live in ``csrc/`` and are compiled with
``nvcc`` on first use (see ``kernels/build.py``).
"""
