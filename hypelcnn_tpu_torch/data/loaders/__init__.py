"""Dataset loaders; importing this package registers them."""

from hypelcnn_tpu_torch.data.loaders import synthetic  # noqa: F401
