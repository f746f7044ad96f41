"""The scorer: micro-batcher, scorer with hot swap, RPC server, entry."""
