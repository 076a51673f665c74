"""Sharding rules and collectives on ``torch.distributed``, ported from
``repro/parallel``: the logical-axis rules table and its DTensor
placements (:mod:`.sharding`), int-N compressed all-reduce
(:mod:`.collectives`)."""
from .sharding import MeshRules, make_rules, param_shardings, shard_act, use_rules
