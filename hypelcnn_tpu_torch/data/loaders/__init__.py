"""Dataset loaders; importing this package registers them.

No try/except around the imports: a broken import must fail here, not as a
confusing "Unknown loader" much later.
"""

from hypelcnn_tpu_torch.data.loaders import (  # noqa: F401
    avon,
    grss2013,
    grss2018,
    gulfport,
    gulfport_alt,
    synthetic,
)
