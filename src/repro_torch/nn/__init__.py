"""Neural-network building blocks of the LM stack, ported from
``repro/nn``: parameter definitions and primitive layers (:mod:`.layers`),
grouped-query attention (:mod:`.attention`), the mixture-of-experts FFN
(:mod:`.moe`) and the recurrent mixers RG-LRU, mLSTM and sLSTM
(:mod:`.recurrent`)."""
from . import attention, layers, moe, recurrent
