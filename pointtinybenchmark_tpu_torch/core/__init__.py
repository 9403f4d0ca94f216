"""Anchors, box coding and post-processing."""
