"""pyjac_tpu_torch.core subpackage (numpy front end)."""
