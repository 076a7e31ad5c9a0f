"""Counterparts of the JAX repository's kernel studies (``studies/``).

Each study there is a Pallas kernel for the sketch hop, or a
microbenchmark of the primitive such a kernel needs, measured on a TPU.
Here each is a CUDA kernel written for Hopper with its plain PyTorch
version beside it, so the same routes can be measured on this card:

  * ``gather_reduce`` (K3): one pass over dst-sorted edges, a fused row
    gather and running min/max per destination;
  * ``sketch_prop`` (K2): one CTA per piece of a destination block's
    edges, the block's running min/max in shared memory, the pieces of a
    long block folded by a second launch;
  * ``dma_gather_rate`` (K4): the per-row gather rate, with a CLI (each
    block's indices sorted before they are gathered).

The TPU studies' conclusions do not carry over to this card.
"""
