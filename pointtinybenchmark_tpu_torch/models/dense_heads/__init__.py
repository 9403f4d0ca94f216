"""dense_heads of the ported detectors."""
