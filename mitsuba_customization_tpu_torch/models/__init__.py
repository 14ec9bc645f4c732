"""BSDF models and the static BSDF dispatch table."""
