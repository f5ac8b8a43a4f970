"""Entry points: `python -m oni_ml_tpu_torch.runner.ml_ops`."""
