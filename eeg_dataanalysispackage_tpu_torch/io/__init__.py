"""Input: BrainVision parsing, the offline data provider, model files."""
