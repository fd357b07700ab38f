"""Runnable examples of the PyTorch port (`python -m dragonboat_tpu_torch.examples.<name>`)."""
