"""The SD-VAE (AutoencoderKL) with diffusers' state-dict layout, and the tiny
distilled autoencoder."""
