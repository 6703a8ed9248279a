"""Part of portbench; see portbench/README.md."""
