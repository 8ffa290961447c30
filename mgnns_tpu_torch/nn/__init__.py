"""Functional eval-mode layers on parameter dicts of torch tensors."""
