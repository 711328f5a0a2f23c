"""A frozen copy of the plain PyTorch forms of ``tadataka_torch``'s
semi-dense VO, DVO and camera code, the benchmark's reference.

Copied module for module, with the imports renamed, from the port as the
benchmark was defined; the SSD window search runs only its plain
version (``vo/semi_dense/sweep.py``), so nothing here builds or launches
a kernel.  Nothing here imports ``tadataka_torch``: a change to the port
does not change its reference.
"""
