"""On-device preprocessing and the protocol tile grid."""
