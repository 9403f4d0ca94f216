"""necks of the ported detectors."""
