"""The strike count of device failures, per site.

The port's copy of the counting half of ``sctools_tpu.guard.degrade``.
JAX's ladder marks a site degraded after a number of device failures and
switches its consumers to a lower rung: the Python decoder, the jnp
whitelist kernel, the CPU backend. The port has no rungs:
``RUNGS`` is empty, because port rule 4 allows no fallback from a kernel,
the native layer or the device to a plain version or to the CPU. So
:func:`note_device_failure` counts ``guard_device_failures`` and
``guard_device_failures_<site>`` and never degrades a site, which is JAX's
own behaviour for a site with no rung (JAX guard/degrade.py:65-76), and
:func:`degraded_sites` (the ``guard_degraded`` flight section) always reads
``{}``. JAX's ``degrade_now``, ``is_degraded`` and ``threshold`` (with
its ``SCTOOLS_TPU_GUARD_DEGRADE_AFTER``) are not ported: with no rung
there is nothing to degrade to, no count to reach, and nothing that would
ask.
"""

from __future__ import annotations

from typing import Dict

from .. import obs
from ..analysis.witness import make_lock

# the rung each site would fall to: none (port rule 4)
RUNGS: Dict[str, str] = {}

_lock = make_lock("guard.degrade")
_failures: Dict[str, int] = {}


def note_device_failure(site: str) -> bool:
    """Count one device-side failure at ``site``; always False (no site
    degrades: the port has no rung to fall to)."""
    obs.count("guard_device_failures")
    obs.count(f"guard_device_failures_{site.replace('.', '_')}")
    with _lock:
        _failures[site] = _failures.get(site, 0) + 1
    return False


# death-path safe (obs.bounded_snapshot): the flight dump may run inside
# a signal handler that interrupted a lock holder on this thread
degraded_sites = obs.bounded_snapshot(_lock, dict, {})
degraded_sites.__doc__ = "Snapshot of degraded sites -> level: always {} on the port."


def failure_counts() -> Dict[str, int]:
    with _lock:
        return dict(_failures)


def reset() -> None:
    """Clear the strike counts (tests)."""
    with _lock:
        _failures.clear()
