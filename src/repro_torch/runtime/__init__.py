"""Runtime services of the port.

    autotune -- measured kernel configurations on the card (diameter
                variant and block, compaction threads, first-order and
                GLCM blocks), cached per bucket and batch depth
"""
