"""On-device preprocessing, the protocol tile grid, batching (loader:
collation, samplers, the training DataLoader) and the point workflow's
pseudo boxes (noise)."""
