"""The parameter-server store: embedding tables and the host parameter
store with its sparse-aware optimizer apply."""
