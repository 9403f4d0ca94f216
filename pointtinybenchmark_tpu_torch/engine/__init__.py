"""Tiled protocol inference engine."""
