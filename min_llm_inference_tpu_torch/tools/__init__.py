"""Entry-point tools of the port (run with ``python -m``)."""
