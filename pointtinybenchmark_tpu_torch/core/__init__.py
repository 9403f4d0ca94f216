"""Anchors, box coding, post-processing, and training's assigner and
samplers."""
