"""Multi-tenant serving of the port (port of ``repro.serve``)."""
