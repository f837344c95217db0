"""Encoder algorithms: block geometry, mode decision, reconstruction, GOP
planning, rate control, TPL and temporal filtering (host side)."""
