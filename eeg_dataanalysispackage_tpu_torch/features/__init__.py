"""Feature extraction: the fe= plugins (DWT on the host or the card)."""
