"""The serving plane of the port: paged KV slab and allocator (pager),
the continuous-batching decode engine (engine), the serving loop with
admission control, bisection and supervised recovery (service), the
replica fleet with routing, autoscaling and failure domains (fleet), the
SLO burn-rate engine (slo) and the engine flight recorder (flight)."""
