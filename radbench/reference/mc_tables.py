"""Marching-cubes lookup tables, generated programmatically.

The benchmark's frozen copy of the port's numpy generator
(``repro_torch/core/mc_tables.py``), so the plain reference meshes a case
with the same table as the program without importing anything of it.

Instead of transcribing the classic Lorensen-Cline 256x16 triangle table (and
risking silent transcription errors that corrupt volume/area results), we
*derive* the table from first principles with a face-consistent pairing
convention:

  * cube corners / edges use the standard MC numbering,
  * on every cube face the isosurface crosses the face boundary an even number
    of times; crossings are paired so that each connection "hugs" only
    *negative* (outside) corners along the CCW walk of the face boundary
    (CCW w.r.t. the outward face normal).  This rule depends only on the
    face's own corner signs, so the two cells sharing a face always agree
    => the global mesh is watertight by construction.
  * connections are *directed* so the inside region lies on the left when
    walking the face with its outward normal up; tracing the directed
    connections yields oriented polygon loops whose fan triangulation has
    outward-pointing normals (verified at generation time).

The ambiguous-face resolution ("separate the positive corners") matches the
behaviour required for closed meshes; it may differ from PyRadiomics' fixed
table on ambiguous configurations (diagonally-touching voxels), which is a
documented implementation choice, not an error -- PyRadiomics' own table is
known to produce non-watertight meshes on those cases.

Exports
-------
CORNERS : (8,3) int  corner offsets within a cell
EDGES   : (12,2) int corner pairs per edge
TRI_TABLE : (256, 3*MAX_TRIS) int32, edge ids per triangle slot, -1 padded
N_TRIS  : (256,) int32 number of triangles per case
MAX_TRIS : int
EDGE_CELL_OFFSET / EDGE_CELL_AXIS : canonical-edge mapping used to dedupe
    mesh vertices into three dense per-axis vertex fields.
"""
from __future__ import annotations

import numpy as np

# Standard MC corner numbering: bottom z=0 ring 0-1-2-3, top z=1 ring 4-5-6-7.
CORNERS = np.array(
    [
        [0, 0, 0],
        [1, 0, 0],
        [1, 1, 0],
        [0, 1, 0],
        [0, 0, 1],
        [1, 0, 1],
        [1, 1, 1],
        [0, 1, 1],
    ],
    dtype=np.int32,
)

EDGES = np.array(
    [
        [0, 1], [1, 2], [2, 3], [3, 0],          # bottom ring
        [4, 5], [5, 6], [6, 7], [7, 4],          # top ring
        [0, 4], [1, 5], [2, 6], [3, 7],          # verticals
    ],
    dtype=np.int32,
)

# Canonical ("owned") edge mapping: every cube edge of cell (i,j,k) is the
# x/y/z-directed grid edge anchored at a grid point.  EDGE_CELL_AXIS[e] gives
# the direction (0=x,1=y,2=z); EDGE_CELL_OFFSET[e] the anchor offset from the
# cell origin.  Used to build dense, duplicate-free vertex fields.
EDGE_CELL_AXIS = np.array([0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2], dtype=np.int32)
EDGE_CELL_OFFSET = np.array(
    [
        [0, 0, 0],  # e0  x-edge @ (i,j,k)
        [1, 0, 0],  # e1  y-edge @ (i+1,j,k)
        [0, 1, 0],  # e2  x-edge @ (i,j+1,k)
        [0, 0, 0],  # e3  y-edge @ (i,j,k)
        [0, 0, 1],  # e4  x-edge @ (i,j,k+1)
        [1, 0, 1],  # e5  y-edge @ (i+1,j,k+1)
        [0, 1, 1],  # e6  x-edge @ (i,j+1,k+1)
        [0, 0, 1],  # e7  y-edge @ (i,j,k+1)
        [0, 0, 0],  # e8  z-edge @ (i,j,k)
        [1, 0, 0],  # e9  z-edge @ (i+1,j,k)
        [1, 1, 0],  # e10 z-edge @ (i+1,j+1,k)
        [0, 1, 0],  # e11 z-edge @ (i,j+1,k)
    ],
    dtype=np.int32,
)


def _edge_id(c0: int, c1: int) -> int:
    for e, (a, b) in enumerate(EDGES):
        if (a, b) == (c0, c1) or (a, b) == (c1, c0):
            return e
    raise ValueError(f"no edge between corners {c0},{c1}")


def _faces():
    """Yield (corner ids CCW w.r.t outward normal, outward normal)."""
    faces = []
    for axis in range(3):
        for side in (0, 1):
            ids = [c for c in range(8) if CORNERS[c][axis] == side]
            normal = np.zeros(3)
            normal[axis] = 1.0 if side == 1 else -1.0
            center = CORNERS[ids].mean(axis=0)
            # build right-handed (u, v, normal) basis
            u = np.zeros(3)
            u[(axis + 1) % 3] = 1.0
            v = np.cross(normal, u)
            ang = []
            for c in ids:
                d = CORNERS[c] - center
                ang.append(np.arctan2(np.dot(d, v), np.dot(d, u)))
            order = [ids[i] for i in np.argsort(ang)]
            faces.append((order, normal))
    return faces


_FACES = _faces()


def _case_connections(inside: np.ndarray):
    """Directed (edge_from -> edge_to) connections for one sign case."""
    conns = []
    for order, _normal in _FACES:
        s = [bool(inside[c]) for c in order]
        # boundary slot i = edge between corner order[i] and order[i+1]
        crossings = [i for i in range(4) if s[i] != s[(i + 1) % 4]]
        if not crossings:
            continue
        eids = [_edge_id(order[i], order[(i + 1) % 4]) for i in range(4)]
        if len(crossings) == 2:
            a, b = crossings
            # corners strictly inside the CCW arc a->b are order[a+1..b]
            arc_ab = [(a + t) % 4 for t in range(1, (b - a) % 4 + 1)]
            if all(not s[i] for i in arc_ab):
                conns.append((eids[a], eids[b]))
            else:
                conns.append((eids[b], eids[a]))
        elif len(crossings) == 4:
            # Alternating signs (ambiguous face).  Pair the crossings that
            # hug each *positive* corner, isolating the positive corners --
            # the 'separate the positives' resolution.  Applied to the face
            # values it is symmetric between the two sharing cells, so the
            # global mesh stays watertight, and unlike the opposite choice it
            # produces no degenerate in-plane neck triangles.  Direction per
            # the general rule: the CCW arc of the directed connection
            # contains only negative corners, i.e. walk the long way around.
            for i in range(4):
                hugged = (i + 1) % 4
                if s[hugged]:
                    conns.append((eids[(i + 1) % 4], eids[i]))
        else:  # pragma: no cover - impossible for a 4-cycle of signs
            raise AssertionError("odd number of face crossings")
    return conns


def _edge_midpoint(e: int) -> np.ndarray:
    a, b = EDGES[e]
    return (CORNERS[a] + CORNERS[b]) / 2.0


# face membership of each cube edge (set of face indices), used to avoid
# fan-triangulating a loop into triangles that lie flat inside a cube face
# (those can coincide with the neighbour cell's triangles).
_EDGE_FACES = [
    frozenset(
        fi
        for fi, (order, _n) in enumerate(_FACES)
        if set(EDGES[e]).issubset(set(order))
    )
    for e in range(12)
]


def _fan(loop):
    """Fan-triangulate a loop, choosing the root that avoids in-face tris."""

    def tris_for_root(r):
        n = len(loop)
        rot = loop[r:] + loop[:r]
        return [(rot[0], rot[i], rot[i + 1]) for i in range(1, n - 1)]

    def n_coplanar(tris):
        return sum(
            1
            for (a, b, c) in tris
            if _EDGE_FACES[a] & _EDGE_FACES[b] & _EDGE_FACES[c]
        )

    best = min((tris_for_root(r) for r in range(len(loop))), key=n_coplanar)
    return best


def _generate():
    tri_lists = []
    for case in range(256):
        inside = np.array([(case >> c) & 1 for c in range(8)], dtype=bool)
        conns = _case_connections(inside)
        succ = {}
        heads = set()
        for f, t in conns:
            assert f not in succ, f"case {case}: edge {f} has two outgoing"
            assert t not in heads, f"case {case}: edge {t} has two incoming"
            succ[f] = t
            heads.add(t)
        assert set(succ) == heads, f"case {case}: open curve"
        # trace directed loops
        tris = []
        remaining = dict(succ)
        while remaining:
            start = min(remaining)
            loop = [start]
            nxt = remaining.pop(start)
            while nxt != start:
                loop.append(nxt)
                nxt = remaining.pop(nxt)
            assert len(loop) >= 3, f"case {case}: degenerate loop {loop}"
            tris.extend(_fan(loop))
        tri_lists.append(tris)

    # Fix global orientation sign using the 8 single-corner cases: the fan
    # normal must point away from the inside corner.
    flips = []
    for c in range(8):
        case = 1 << c
        (a, b, d) = tri_lists[case][0]
        pa, pb, pd = _edge_midpoint(a), _edge_midpoint(b), _edge_midpoint(d)
        n = np.cross(pb - pa, pd - pa)
        outward = pa - CORNERS[c]  # from inside corner toward the patch
        flips.append(float(np.dot(n, outward)) < 0)
    assert len(set(flips)) == 1, "inconsistent orientation across corner cases"
    if flips[0]:
        tri_lists = [[(a, d, b) for (a, b, d) in tris] for tris in tri_lists]

    max_tris = max(len(t) for t in tri_lists)
    table = np.full((256, max_tris * 3), -1, dtype=np.int32)
    ntris = np.zeros(256, dtype=np.int32)
    for case, tris in enumerate(tri_lists):
        ntris[case] = len(tris)
        for i, (a, b, d) in enumerate(tris):
            table[case, 3 * i : 3 * i + 3] = (a, b, d)
    return table, ntris, max_tris


TRI_TABLE, N_TRIS, MAX_TRIS = _generate()
