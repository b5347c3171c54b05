"""Host data plane of the port: schema, CSV ingest, synthetic wells (numpy)."""
