"""The benchmark's plain references: the served models in PyTorch alone,
one module a configuration.

A configuration file ``bench/configs/<config>.json`` names its module
under a top-level ``"reference"``: ``bench/reference/<module>.py``, or
``model.py`` where it names none.  The harness loads that file by path
from the checkout's ``bench/`` (``harness.reference_module``), outside
this package, so a module imports what it shares with another
absolutely (``from bench.reference.model import rmsnorm``).  It imports
nothing of the program.

Every module exports, each a function of the configuration's ``arch``
block:

- ``layout(arch)``: the weights as the benchmark draws them, a nested
  dict of ``(shape, dtype, init)`` leaves (``bench/weights.py``); the
  same tensors are handed to the program.  ``layout(arch)["blocks"]``
  holds the layers, an expert stack as a 4-D leaf under an ``ffn`` key.
- ``logits_at(params, arch, seqs, positions, precision)``: f32 logits
  of each sequence at the positions asked for; ``precision`` ``"f32"``
  is the reference (float32, TF32 off), ``"fp8"`` the control (every
  weight product through float8 e4m3).
- ``layer_kinds(arch)``: ``[(mixer, ffn)]`` of one period of the layer
  pattern; the counts read mixer ``"G"`` as attention and ``"M"`` as a
  Mamba layer.
- ``n_periods(arch)``: how many times the period repeats.
- ``ssm_dims(arch)``: (inner width, heads, head size, state size) of a
  Mamba layer, where a period holds one and the module has no
  ``ssm_flops``.

and may export ``ssm_flops(arch)``: each token's FLOPs in the conv and
scan of all its Mamba layers, where they count otherwise than one B/C
group (``bench/counts.py``).
"""
