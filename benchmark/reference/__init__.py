"""The benchmark's plain reference: its own GFA parser, a gap-affine DP in
plain PyTorch, and the comparisons that decide ``correct``.

Nothing here imports ``jax``, ``poasta_tpu`` or ``poasta_tpu_torch``, and
nothing here takes what the program made: it parses the GFA text the
harness wrote and works out the topological order, the predecessors and
the scores again.
"""
