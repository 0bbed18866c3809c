"""pyjac_tpu.runtime subpackage (native C++ runtime components)."""
