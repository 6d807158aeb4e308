"""Runtime services of the port.

    autotune  -- measured kernel configurations on the card (diameter
                 variant and block, compaction threads, first-order and
                 GLCM blocks), cached per bucket and batch depth; the sync
                 and hardware probes
    costmodel -- the auto knobs' decisions (schedule='auto', stream
                 windows, the service's deadlines) from the cache and the
                 plan census
    roofline  -- the kernels' counted work and its roofline price
"""
