"""pomfret_tpu — a methylation-assisted phase block joiner on JAX.

A from-scratch reimplementation of the capabilities of nanoporetech/pomfret
(reference v0.1-r14) with a JAX device engine:

- IO layer: own BGZF/BAM/BAI/VCF/GTF stack (no htslib dependency), with an
  optional C++ fast path for the hot decode loops.
- Compute layer: the methmer scoring engine and the iterative gap-phasing loop
  are expressed as dense JAX array programs (jit / vmap / lax.while_loop),
  compiled by XLA for the GPU.
- Scale-out: gaps are the unit of distribution; batches of gap windows are
  sharded over a jax.sharding.Mesh, with deterministic replicated reduction of
  per-gap decisions.

Reference parity: the decision pipeline reproduces the semantics of
blockjoin.c (see SURVEY.md for the layer map and file:line citations).
"""

__version__ = "0.1.0"

VERSION = "v0.1-tpu-r1"  # mirrors reference VERSION at blockjoin.h:5
