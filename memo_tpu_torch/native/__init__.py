from memo_tpu_torch.native.build import load_libms  # noqa: F401
