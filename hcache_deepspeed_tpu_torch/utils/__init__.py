"""Utilities (reference: ``hcache_deepspeed_tpu/utils``)."""
