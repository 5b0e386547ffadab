"""The port's command lines: ``python -m xgnn_tpu_torch.examples.train``
and ``python -m xgnn_tpu_torch.examples.accuracy``."""
