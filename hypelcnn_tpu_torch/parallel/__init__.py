"""Data parallelism on ``torch.distributed`` (``hypelcnn_tpu/parallel``)."""
