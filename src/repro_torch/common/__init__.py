"""Shared helpers: jax-compatible PRNG, parameter trees, device choice."""
