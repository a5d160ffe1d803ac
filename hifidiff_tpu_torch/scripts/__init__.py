"""The quality scripts (counterparts of the JAX package's `scripts/*_quality.py`
and `scripts/idc_hard_demo.py`): each measures a fast mode's end-to-end
quality on the stack `cli/convergence_demo` trains, and writes its record to
a `*_TORCH.json` file at the repo root.

    python -m hifidiff_tpu_torch.scripts.cache_quality
    python -m hifidiff_tpu_torch.scripts.tae_quality --device cpu
"""
