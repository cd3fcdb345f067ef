"""Multi-process helpers. The sharded scatter-gather of the JAX package
(parallel/sharded.py, K7) is a later slice of the port; the rendezvous
helper is pure host code used by the index store."""

from .rendezvous import rendezvous_shard

__all__ = ["rendezvous_shard"]
