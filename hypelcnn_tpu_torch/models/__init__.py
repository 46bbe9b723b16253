"""Model families; importing this package registers them."""

from hypelcnn_tpu_torch.models import cap, concnn, dualcnn, hypelcnn  # noqa: F401
