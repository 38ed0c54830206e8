"""The LM scaffold's synthetic token stream (port of ``repro.data``)."""
