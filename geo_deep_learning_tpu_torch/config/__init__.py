"""Process configuration: logging."""
