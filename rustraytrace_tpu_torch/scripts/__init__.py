"""Scripts of the port, run as modules (``python -m
rustraytrace_tpu_torch.scripts.<name>``)."""
