"""PyTorch / CUDA port of the Kairos serving system.

Mirrors the layout of the JAX package ``repro`` module for module; the
JAX package stays the reference the port is tested against.  The port
imports ``torch`` and numpy only.  Its entry points run on the CUDA card
unless the caller passes ``device="cpu"``.
"""
