"""Per-layer metric readers, one file each, named as the metric; `_shared`
holds what they share."""
