"""Classifiers, the SGD engine and classification statistics."""
