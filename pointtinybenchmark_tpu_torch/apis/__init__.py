"""User-facing inference API."""
from .inference import inference_detector_tiled, init_detector

__all__ = ["init_detector", "inference_detector_tiled"]
