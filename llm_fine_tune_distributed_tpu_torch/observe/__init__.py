"""Metrics: training (the logger and the trainer's telemetry) and serving
(stats, tracing, SLOs, capacity, FLOPs and the profiler)."""
