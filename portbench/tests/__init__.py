"""CPU tests of the benchmark (card-only ones skip without CUDA)."""
