"""Deterministic token data (numpy only): a copy of ``repro.data``."""
