// Generated by repro_torch.kernels.marching_cubes.write_edge_table_header
// from repro_torch/core/mc_tables.py EDGE_CELL_AXIS and EDGE_CELL_OFFSET:
// cube edge e's 5 bits at bit 5 * e, its axis (bits 0-1) and its anchor's
// offset from the cell origin, x (bit 2), y (bit 3), z (bit 4).  The edge
// joins the anchor and the grid point one step along the axis, corners
// c0 and c1 of mc_tables.EDGES.  Do not edit.
//    e  axis  offset   corners
//    0  x     (0,0,0)  0-1
//    1  y     (1,0,0)  1-2
//    2  x     (0,1,0)  2-3
//    3  y     (0,0,0)  3-0
//    4  x     (0,0,1)  4-5
//    5  y     (1,0,1)  5-6
//    6  x     (0,1,1)  6-7
//    7  y     (0,0,1)  7-4
//    8  z     (0,0,0)  0-4
//    9  z     (1,0,0)  1-5
//   10  z     (1,1,0)  2-6
//   11  z     (0,1,0)  3-7
#pragma once

constexpr unsigned long long kEdgeCode = 0x0538c28e2b00a0a0ULL;
