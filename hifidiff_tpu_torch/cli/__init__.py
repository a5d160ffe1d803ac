"""Entry points of the port (counterpart of hifidiff_tpu/cli/): the batching
server (`serve`), the offline eval (`test_refiner`), the server's load
generator (`serve_bench`), the training stages (`train_vae`, `train_cr`,
`pretrain_idc`, `pretrain_denoiser`, `train_refiner`), the IDC's
verification eval (`test_idc`) and the end-to-end `convergence_demo`."""
