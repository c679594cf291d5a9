"""Per-metric readers, found by name: ``<metric>.py`` with ``read(record)``."""
