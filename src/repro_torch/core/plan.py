"""Vertex-bucket ladder (the single-case slice of ``repro.core.plan``).

The rest of the reference plan layer (shape buckets, extraction plans,
vertex hints, the family registry) belongs to the batched executor and is
not ported yet.
"""
from __future__ import annotations

MIN_VERTEX_BUCKET = 512  # the vertex_bucket ladder floor


def vertex_bucket(n: int, minimum: int = MIN_VERTEX_BUCKET) -> int:
    """Power-of-two padding cap for a vertex count (floor ``minimum``)."""
    b = minimum
    while b < n:
        b *= 2
    return b
