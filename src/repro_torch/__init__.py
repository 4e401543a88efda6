"""PyTorch/CUDA port of ``repro`` (random-bases descent training).

The port mirrors the layout of the JAX package ``repro`` so that each
module's counterpart is easy to find.  It imports torch and numpy only,
never jax and nothing of ``repro``; entry points run on the GPU unless
the caller passes ``device="cpu"``.
"""
