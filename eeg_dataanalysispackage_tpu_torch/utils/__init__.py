"""Constants, Java-compatible helpers and the device helper."""
