"""The LM side of the port: architecture config, parameter schema, layers
and the dense transformer (the part of the reference's ``repro.models``
that the serving engine runs)."""
