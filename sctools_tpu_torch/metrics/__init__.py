"""Per-cell and per-gene QC metrics on the device (``CalculateCellMetrics`` /
``CalculateGeneMetrics``): schema, engine, streaming gatherer, CSV writer."""
