"""Mamba2 SSD chunked scan: the plain oracle (``ref``), the CUDA kernel's
wrapper (``kernel``) and the model-layout entry point (``ops``)."""
