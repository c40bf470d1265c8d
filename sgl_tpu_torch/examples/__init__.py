"""Runnable pipelines of the port (``python -m sgl_tpu_torch.examples.<name>``)."""
