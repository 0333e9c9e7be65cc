"""Gradient-sync codecs (only the int8 row quantizer's entry so far)."""
