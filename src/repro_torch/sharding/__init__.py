"""Partitioning rules of the model-sharded layouts (port of
``repro.sharding``)."""
