"""Entry points of the port (counterpart of hifidiff_tpu/cli/): the batching
server (`serve`), the offline eval (`test_refiner`) and the server's load
generator (`serve_bench`)."""
