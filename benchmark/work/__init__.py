"""The counted work of a step or a request, from shapes alone, and the
card's peaks it is held to.  ``<name>.py`` holds the required operations
of one kind of step (``required(cfg, traffic)``: ``(name, bytes, flops,
source)`` an operation, ``source`` the ``kernels/<source>.json`` of the
program that carries it, or None where PyTorch's own operations do);
``counts.py`` the work of each operation; ``peaks.py`` the rates."""
