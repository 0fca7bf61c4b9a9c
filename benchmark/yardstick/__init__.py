"""The benchmark's yardstick: what later changes to the program cannot
move. Inputs (``inputs``), FLOP and byte counts (``flops``,
``pyramid``), the device trace's reduction (``trace``), a plain TIFF
reader (``tiff``), the card's published peaks (``peaks``), the plain
reference of the served path (``reference``) and the comparison that
decides ``correct`` (``check``). Nothing here imports the program."""
