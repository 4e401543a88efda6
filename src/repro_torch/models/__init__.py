"""Dense decoder models (dict-of-tensors parameters)."""
