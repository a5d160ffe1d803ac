"""Logging, image grids and profiling hooks, device-side timing and the
execution-discipline checks (counterpart of hifidiff_tpu/utils/)."""
