"""Tensor ops: norms, gates, embeddings, pixel shuffle, the affine warp and
the torch-bicubic resize, with the dispatch to the hand-written CUDA
kernels (`kernels`)."""
