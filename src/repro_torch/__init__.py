"""PyTorch / CUDA port of the Antler reproduction.

Mirrors ``repro`` module for module and never imports it (nor JAX): this
package runs on a GPU host that has neither.  Entry points run on ``cuda``
unless the caller names another device.
"""
