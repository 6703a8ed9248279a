"""AdamW's clipping norm and update: the plain loop (``ref``) and the
CUDA kernels' wrappers (``kernel``)."""
