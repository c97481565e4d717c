"""Data parallelism across processes: ``parallel.dist``."""
