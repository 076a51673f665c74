"""Neural-network building blocks of the LM stack, ported from
``repro/nn``: parameter definitions and primitive layers (:mod:`.layers`)
and grouped-query attention (:mod:`.attention`).  ``moe`` and ``recurrent``
wait for their families (``ROADMAP.md`` queue 1 item 9)."""
from . import attention, layers
