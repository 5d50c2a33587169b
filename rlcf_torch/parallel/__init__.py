"""Episode data parallelism and class, gallery and OPT tensor parallelism over
``torch.distributed`` (the counterpart of ``rlcf_tpu/parallel/``)."""
