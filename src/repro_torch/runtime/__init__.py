"""Serving runtime on one card: plans and prefill / decode steps."""
