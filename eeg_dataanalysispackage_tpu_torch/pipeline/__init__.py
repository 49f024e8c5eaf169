"""The query-string pipeline builder and its CLI."""
