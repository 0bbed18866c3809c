"""pyjac_tpu_torch.parallel subpackage (chunked batch evaluation)."""
