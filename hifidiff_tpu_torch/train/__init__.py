"""Training: losses, optimizers and schedules, the train steps of the four
stages (CR, IDC, denoiser, refiner) and of the VAE, and checkpoints
(counterpart of hifidiff_tpu/train/)."""
