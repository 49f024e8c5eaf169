"""Epochs: window validity, class balancing and host epoch extraction."""
