"""Ops: sparse convolution (host rulebook, forward and scatter-free
backwards), the hat planner and interpolation with its CUDA kernels,
positional encoding, compositing."""
