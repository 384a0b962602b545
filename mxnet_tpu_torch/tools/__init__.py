"""Measurement tools of the port, run on the card (`python -m
mxnet_tpu_torch.tools.<name>`)."""
