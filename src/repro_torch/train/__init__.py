"""The single-machine training session."""
