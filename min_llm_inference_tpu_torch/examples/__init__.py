"""Examples of the port's public API (run with ``python -m``)."""
