"""Parallelism of the port.

    sharding -- a single-controller mesh of devices (``Mesh``), its ambient
                context (``use_mesh``/``active_mesh``) and the data-parallel
                map that shards a batched device function over the mesh's
                ``data`` axis (``data_parallel_map``, ``pad_batch``,
                ``axis_size``), and the LLM scaffold's logical-axis rules
                (``Ax``, ``DEFAULT_RULES``, ``pspec``, ``constrain``)
"""
