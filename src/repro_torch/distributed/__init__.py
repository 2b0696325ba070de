"""The pure functions of ``repro.distributed`` that run on one device:
gradient compression with error feedback (the optimizer's
``grad_transform`` hook)."""
