"""Launchers: command-line drivers of the port (``serve``)."""
