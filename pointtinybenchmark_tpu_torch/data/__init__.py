"""On-device preprocessing, the protocol tile grid, and batching (loader:
collation, samplers, the training DataLoader)."""
