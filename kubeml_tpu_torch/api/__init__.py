"""Wire-level types of the port: errors and the error envelope
(``errors``), the wire types (``types``) and constants (``const``)."""
