"""The repo's scene configurations, built without the JAX package."""
