"""The PyTorch backend: compiled layers, parameter graphs, folding,
graph rewrites and the evaluation plan (the counterpart of
``cirkit_tpu.backend.jax``)."""
