"""Parallelism of the port.

    sharding    -- a single-controller mesh of devices (``Mesh``), its ambient
                   context (``use_mesh``/``active_mesh``) and the data-parallel
                   map that shards a batched device function over the mesh's
                   ``data`` axis (``data_parallel_map``, ``pad_batch``,
                   ``axis_size``); the LLM scaffold's logical-axis rules
                   (``Ax``, ``DEFAULT_RULES``, ``pspec``, ``constrain``), its
                   layouts over a mesh (``NamedSharding``, ``param_shardings``,
                   ``tree_shardings``, ``AbstractMesh``) and
                   ``shard_map_compat``, a thread a slot with ``psum``,
                   ``pmax``, ``ppermute`` and ``axis_index`` over named
                   axes; ``ModelGroup``, a data row's ``model`` slots as one
                   autograd graph (``reduce``, ``handout``, ``first``)
    compression -- int8 error-feedback gradient reduction
                   (``compressed_psum_tree``)
    pipeline    -- GPipe over the ``pod`` axis (``pipeline_forward``)
"""
