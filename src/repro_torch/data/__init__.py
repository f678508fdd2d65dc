"""Synthetic token pipeline (own copy of ``repro.data``)."""
