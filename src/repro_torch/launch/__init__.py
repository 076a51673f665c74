"""Launchers, ported from ``repro/launch``: the single-device training loop
(:mod:`.train`).  The mesh, dry-run and analysis launchers wait for the
mesh slice."""
