"""Data parallelism over torch.distributed (counterpart of ``tha4_tpu/parallel``)."""
