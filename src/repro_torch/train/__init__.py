"""Training (port of ``repro.train``): AdamW, the Honeycomb-cataloged
checkpoint manager and the train loop."""
