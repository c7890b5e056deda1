"""Serving runtime: plans, placements across a mesh of ranks, prefill / decode steps."""
