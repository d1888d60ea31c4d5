"""Online caption serving on the batch-at-a-time shape ladder: engine,
micro-batcher, caches, metrics and the HTTP front end."""
