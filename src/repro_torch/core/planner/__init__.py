"""Planners that price placements (the DT-FM cost model)."""
