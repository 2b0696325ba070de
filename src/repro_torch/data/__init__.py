"""The token pipeline (port of ``repro.data``)."""
