"""Serving layer of the port.  This slice carries :class:`Overloaded`, the
typed load-shed error the elastic runtime raises; the multi-tenant server,
its scheduler, admission control and load generator come with the serving
slice."""
from .admission import Overloaded

__all__ = ["Overloaded"]
