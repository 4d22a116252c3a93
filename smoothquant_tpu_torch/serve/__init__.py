"""Serving: the continuous batcher over the stacked S-major int8 pool."""
