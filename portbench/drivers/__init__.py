"""The drivers, one module a traffic kind (``traffic/<name>.json``'s
``"kind"``), loaded by that name.  A driver has two functions:

``run(conf, traffic, limits, seed, seconds, traced, device, fault=None)``
    builds the system at the configuration ``conf``, warms the mix's shapes,
    drives the window for ``seconds`` and compares what it produced with the
    plain reference; returns a dict with ``window_start`` (the host clock at
    the first timed call), ``window_s``, ``attempted``, ``failed``,
    ``peak_bytes``, ``profile`` (traced: kernels, the traced window, the
    benchmark's spans; else None), ``checks`` (each compared number as
    ``{"value", "limit"}``, and ``pass``) and whatever its cell's metric
    readers read.  ``fault`` breaks the timed path (the benchmark's tests).

``readings(conf, traffic, limits, seed, seconds, device)``
    the rows that ``control.py`` writes: the sound system's compared numbers
    and, beside them, the control's and the faults' on the same seed.
"""
