"""detectors of the ported detectors."""
