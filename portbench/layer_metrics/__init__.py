"""Per-layer metrics, one reader a file named as the metric:
``read(readings, ctx) -> float | None``.  ``readings`` is what the cell's
traffic returned (``readings["trace"]``: the traced span's summary,
``portbench.trace``); a reader with nothing to read returns None."""
