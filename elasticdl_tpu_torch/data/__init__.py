"""Record files, examples and the streaming Dataset."""
