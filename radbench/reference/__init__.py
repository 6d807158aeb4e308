"""Plain reference of the features the benchmark's cells compare.

Plain PyTorch, with no kernel, batching, pruning or state of the program:
it imports nothing of ``repro_torch`` (nor the JAX package) and works from
the ``(image, mask, spacing)`` the program was handed.
"""
