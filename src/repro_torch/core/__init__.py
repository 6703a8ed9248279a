"""Host-side models of energy, carbon, FLOPs, faults and the wide-area
network (copies of the parts of ``repro.core`` the port calls)."""
