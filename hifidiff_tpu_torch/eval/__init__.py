"""Evaluation metrics (counterpart of hifidiff_tpu/eval/)."""
