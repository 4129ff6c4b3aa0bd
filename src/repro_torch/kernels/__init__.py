"""Hand-written CUDA kernels of the port, each beside its plain torch
version.  ``duct_exchange`` holds the dense duct layout's window and
commit ops."""
