"""Core numerics: sampler, vector math, frames, warps, distributions."""
