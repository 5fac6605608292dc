"""Utilities: device resolution and transfer, the CUDA build, synthetic
scenes and the weight and optimizer-state transplant from the JAX
package."""
