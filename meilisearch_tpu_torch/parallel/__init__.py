"""Multi-process execution. Lazy exports: importing this package loads
no torch.distributed code (the rendezvous helper is pure host code used
by the index store)."""

from .rendezvous import rendezvous_shard

__all__ = ["sharded_query_topk", "sharded_store_topk", "make_group", "rendezvous_shard"]


def __getattr__(name):
    if name in ("sharded_query_topk", "sharded_store_topk", "make_group",
                "store_chain_inputs", "sharded_facet_counts", "sharded_vector_topk"):
        from . import sharded

        return getattr(sharded, name)
    raise AttributeError(name)
