"""roi_heads of the ported detectors."""
