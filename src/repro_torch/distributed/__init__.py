"""The port of ``repro.distributed``: gradient compression with error
feedback (``compression``, the optimizer's ``grad_transform`` hook), the
sharding rules (``sharding``), the locality-preserving paged decode
(``paged_attention``) and the GPipe schedule (``pipeline``).

The mesh modules run one process per device over a ``torch.distributed``
world (NCCL on the card, gloo on the CPU; the reference's ICI
collectives), on a ``DeviceMesh`` whose dimension names are the
reference's axes; where the reference hands out ``NamedSharding``s they
give DTensor placements, and their ``shard_map`` bodies run through
``repro_torch.compat.shard_map``.
"""
