"""The harness's own spans, recorded into the profiler's trace.

``span(name)`` marks a stretch of the harness's thread as
``gpubench.<name>`` (a ``torch.profiler.record_function`` range, which costs
a few microseconds when no profiler runs). ``install`` wraps calls into the
program's layers for the traced run only, so that an idle gap on the card
can be labelled with what the host was doing. A target that the program no
longer has is skipped: the labels get coarser, the run goes on.
"""

from __future__ import annotations

import functools
import importlib
from typing import Iterable, List, Tuple

_installed: List[Tuple[object, str, object, bool]] = []


def span(name: str):
    from torch.profiler import record_function

    return record_function(f"gpubench.{name}")


def install(targets: Iterable[Tuple[str, str, str]]) -> None:
    """Wrap each ``(module, attribute path, label)`` in a span ``label``."""
    for module_name, path, label in targets:
        try:
            owner = importlib.import_module(module_name)
            *parents, name = path.split(".")
            for parent in parents:
                owner = getattr(owner, parent)
            original = getattr(owner, name)
        except (ImportError, AttributeError):
            continue
        own = not isinstance(owner, type) or name in owner.__dict__
        if isinstance(owner, type) and isinstance(owner.__dict__.get(name), (staticmethod, classmethod)):
            continue

        def wrapper(*args, _original=original, _label=label, **kwargs):
            with span(_label):
                return _original(*args, **kwargs)

        functools.update_wrapper(wrapper, original)
        setattr(owner, name, wrapper)
        _installed.append((owner, name, original, own))


def uninstall() -> None:
    while _installed:
        owner, name, original, own = _installed.pop()
        if own:
            setattr(owner, name, original)
        else:
            delattr(owner, name)
