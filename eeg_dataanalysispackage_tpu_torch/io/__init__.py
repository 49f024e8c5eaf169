"""Input: BrainVision parsing, the offline data provider, model files,
and the local and remote filesystems they read through."""
