"""The part of ``sctools_tpu.guard`` the scheduler reads: the quarantine
sidecars' reader (:mod:`.quarantine`).

The JAX guard's recovery ladder, watchdogs and degradation are not ported:
a failed batch fails its task, which the scheduler retries and then
quarantines.
"""
