"""Adapters to the entries of the port, one file an adapter, found by the
name a cell's parameters give (``"adapter"``).  An adapter's ``start(ctx)``
returns a caller with ``warm_up()``, ``step()`` (one call of the entry;
returns the reads it completed, results on the host), ``counters()``,
``outputs()`` (what its check compares) and ``close()``.  ``port.py``
holds every name of the port that they call.
"""
