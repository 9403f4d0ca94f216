"""backbones of the ported detectors."""
