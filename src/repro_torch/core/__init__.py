"""Host-side models of energy, carbon, FLOPs and faults (copies of the
parts of ``repro.core`` the serving engine calls)."""
