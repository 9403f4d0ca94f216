"""Detector models (mmdet names and state_dict keys)."""
from .builder import build_detector

__all__ = ["build_detector"]
