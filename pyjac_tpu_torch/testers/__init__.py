"""pyjac_tpu_torch.testers subpackage."""
