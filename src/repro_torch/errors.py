"""Typed error taxonomy shared across layers.

Lives in its own dependency-free top-level module so the serving layer
(broker, fleet) can raise the same typed errors the tier chain catches
without importing ``repro_torch.core`` — whose package init imports serving
right back.
"""

from __future__ import annotations


class BackendError(RuntimeError):
    """A tier backend failed; the handler falls through to the next tier."""


class SchedulerStopped(BackendError):
    """Submit reached a draining/stopped scheduler.

    Raised by :meth:`SessionBroker.submit` instead of enqueueing into a
    dead mailbox: the request would otherwise sit unserved until the
    caller's ``result()`` timeout. A typed, prompt signal is what the
    fleet's circuit breaker keys on to retire a replica.
    """
