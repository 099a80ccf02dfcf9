"""Data parallelism on `torch.distributed`: one rank per device, the
note × velocity grid or the stream axis split over the ranks. Port of
`openwurli_tpu/parallel/`."""
