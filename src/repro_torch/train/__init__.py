"""Serving steps of the LM stack (:mod:`.serve`), ported from
``repro/train``.  The optimizer and trainer wait for the training slice."""
