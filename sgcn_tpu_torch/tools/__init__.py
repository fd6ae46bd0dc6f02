"""Measurement tools of the port (``python -m sgcn_tpu_torch.tools.<name>``)."""
