"""Model families; importing this package registers them."""

from hypelcnn_tpu_torch.models import hypelcnn  # noqa: F401
