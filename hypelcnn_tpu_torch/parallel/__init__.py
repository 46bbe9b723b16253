"""Data and tensor parallelism on ``torch.distributed`` (``hypelcnn_tpu/parallel``)."""
