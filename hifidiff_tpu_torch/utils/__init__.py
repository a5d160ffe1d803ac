"""Logging, image grids and profiling hooks (counterpart of
hifidiff_tpu/utils/)."""
