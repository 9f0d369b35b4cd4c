"""The port's examples (twins of the JAX repository's `examples/`), each
runnable with ``python -m ray_lightning_tpu_torch.examples.<name>`` and
``--smoke-test --device cpu`` on synthetic data."""
