"""Launchers: command-line drivers of the port (``serve``, ``tiled_smoke``)
and the host mesh (``mesh.make_host_mesh``)."""
