"""The plain reference of the simulator: a frozen copy of the port's
``config``, ``env``, ``rollout``, ``maps/loader``, ``parallel/draws`` and
the ``ops`` that a step of the benchmark's cells runs, in which every
hand-written kernel is replaced by its plain PyTorch twin on every device:
the scan megakernel by ``mega_edge_ttc_reference`` (its spectra, render,
noise + iTTC and opponent twins), the state kernel by the eager chain
(``prestep_reference``), the epilogues by their ``*_reference`` twins, the
march by the compacting ``march_reference``.  Besides those dispatchers
the copy differs from the port in three places: no range-texture disk
cache, no spectral render, and no float32-precision guard in
``trace_fast_mxu`` (the caller sets the precision: the TF32 control runs
the same code with TF32 on).  It imports nothing of the program, so a
later change to the port moves the program and never its yardstick.
"""
