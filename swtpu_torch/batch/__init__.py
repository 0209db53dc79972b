from swtpu_torch.batch.traceback import sw_align_batch  # noqa: F401
