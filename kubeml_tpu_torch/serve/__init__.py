"""The serving plane of the port: paged KV slab and allocator (pager),
the continuous-batching decode engine (engine) and the serving loop with
admission control (service)."""
