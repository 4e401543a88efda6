"""Named exports with CRC-checked sidecars (port of the named half of
``repro.checkpoint``)."""
