"""pyjac_tpu_torch.ops subpackage (PyTorch kernels and their plain versions)."""
